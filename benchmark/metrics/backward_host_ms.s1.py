"""Host ms a stage-1 step of span ``svgir.backward``: the autograd pass
(``trainer.loss_grads``), every backward span inside it, from the program's
span registry (``svgir_tpu_torch.utils.profiling``) over the traced window's
steps. The span's host time is taken under the profiler, which adds its own
cost to each operation the host dispatches: it is comparable only from one
traced run to another. The stage-1 step is host-bound, so its device
intervals follow the host, and these spans give host time alone."""

from benchlib import spans


def read(ctx):
    return spans.host_ms_a_step(ctx, 1, "svgir.backward")
