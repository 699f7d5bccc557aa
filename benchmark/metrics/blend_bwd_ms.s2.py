"""Device ms a stage-2 step of the blend's backward: span ``svgir.blend.bwd``
(``ops/rasterizer.py``, inside the blend Function's backward: the weight-sum
cotangent's gather, the backward kernel B4 with its zero fill, and the
per-Gaussian sums of its rows), from the program's span registry
(``svgir_tpu_torch.utils.profiling``) over the traced window's steps. The
span's device ms is its interval on the stream, from the CUDA event at its
entry to the one at its exit, idle time inside it included."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_a_step(ctx, 2, "svgir.blend.bwd")
