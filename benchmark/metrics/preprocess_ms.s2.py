"""Device ms a stage-2 step of the rasterizer's preprocess: spans
``svgir.preprocess`` (its forward, ``ops/preprocess.py`` ``preprocess``)
and ``svgir.preprocess.bwd`` (its backward, between the marks on its
outputs and inputs), from the program's span registry
(``svgir_tpu_torch.utils.profiling``) over the traced window's steps.
Each span's device ms is its interval on the stream, from the CUDA event
at its entry to the one at its exit, idle time inside it included."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_a_step(ctx, 2, "svgir.preprocess",
                                  "svgir.preprocess.bwd")
