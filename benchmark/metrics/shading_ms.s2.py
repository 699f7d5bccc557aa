"""Device ms a stage-2 step of the shading: spans ``svgir.shading`` (the env
lookup B7's forward and ``rendering_equation4`` in ``render_view_svgss``)
and ``svgir.shading.bwd`` (the backward of ``rendering_equation4``, between
the marks on its outputs and inputs), from the program's span registry
(``svgir_tpu_torch.utils.profiling``) over the traced window's steps. B7's
backward waits for the consistency loss's share of the env lookup's
cotangent too, so it runs outside both and keeps a span of its own
(``svgir.env_lookup.bwd``). Each span's device ms is its interval on the
stream, from the CUDA event at its entry to the one at its exit, idle time
inside it included: on one H100 the traced stage-2 window is about 3%
idle."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_a_step(ctx, 2, "svgir.shading",
                                  "svgir.shading.bwd")
