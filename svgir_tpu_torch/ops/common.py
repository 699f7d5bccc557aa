"""Constants of the per-(Gaussian, pixel) blend math and the depth
finalization, shared by the blend kernels' plain versions and the
rasterizer.

Transmittance is kept in log space: every passing splat adds
``log1p(-alpha)`` and contributions are gated by ``logT_before >=
log(1e-4)`` (the reference latches a ``done`` flag instead; see
``svgir_tpu/ops/common.py``).  ``csrc/blend_common.cuh`` holds the same
constants for the CUDA kernels.
"""

from __future__ import annotations

import torch


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the kernels' ``float`` constants and a
    float32 tensor's comparisons take it: the plain versions run on float64
    inputs then clamp and gate at the same values."""
    return float(torch.tensor(x, dtype=torch.float32))


ALPHA_MIN = _f32(1.0 / 255.0)
ALPHA_MAX = _f32(0.99)
LOG_T_EPS = _f32(-9.210340371976182)  # log(1e-4)
NG = 12                               # geometry rows of a blend slab row


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device is refused."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def finalize_depth(D: torch.Tensor, T: torch.Tensor,
                   normalize_depth: bool) -> torch.Tensor:
    """forward.cu:689: D/(1-T) when normalizing (guarded), else D + 10*T."""
    if normalize_depth:
        return D / torch.clamp(1.0 - T, min=1e-6)
    return D + T * 10.0
