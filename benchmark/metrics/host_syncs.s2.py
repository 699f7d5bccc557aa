"""Host synchronizations a stage-2 step: the program's ``host_syncs``
counter (``svgir_tpu_torch.utils.profiling``), charged inside its
``svgir.step`` spans over the traced window, over the registry's steps. Each
point where the step's host waited for the device counts once: CUDA's sync
debug mode flags the implicit ones (``.item()``, a copy between host and
device, ``nonzero``), and the program's own synchronizes count through
``profiling.synchronize``. A count, from the host; the profiler's cost does
not change it."""

from benchlib import spans


def read(ctx):
    return spans.syncs_a_step(ctx, 2)
