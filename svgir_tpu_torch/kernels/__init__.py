"""Wrappers of the hand-written CUDA kernels in ``svgir_tpu_torch/csrc``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current stream, raises if the launch failed, and
adds one to its entry in ``LAUNCHES``.  The wrappers take CUDA tensors
only; the ``ops`` modules choose between a wrapper and the kernel's plain
PyTorch version by the device of the tensors they are given.
"""

from collections import Counter

# kernel name -> launches since the last reset_launches()
LAUNCHES: Counter = Counter()

KERNEL_NAMES = ("binning_counts", "binning_instances", "blend_forward",
                "blend_backward", "blend_forward_tiles", "blend_backward_tiles",
                "env_lookup_forward", "env_lookup_backward", "march",
                "pad_cols", "slice_cols", "consistency_forward",
                "consistency_backward", "shading_forward",
                "shading_backward", "preprocess_forward",
                "preprocess_backward", "gaussian_rows")


def reset_launches() -> None:
    LAUNCHES.clear()


def launches() -> dict:
    return {name: LAUNCHES[name] for name in KERNEL_NAMES}
