"""Real spherical harmonics, degrees 0..4.

Constants and band layout match the reference ``utils/sh_utils.py`` and
``svgir_tpu.utils.sh``.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values at unit ``dirs`` [..., 3] -> [..., (deg+1)**2]."""
    assert 0 <= deg <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if deg > 2:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3 * yy)]
    if deg > 3:
        out += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
                C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
                C4[4] * (zz * (35 * zz - 30) + 3), C4[5] * xz * (7 * zz - 3),
                C4[6] * (xx - yy) * (7 * zz - 1), C4[7] * xz * (xx - 3 * yy),
                C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def band_index(deg: int, device=None) -> torch.Tensor:
    """Band (degree) of each SH coefficient: [0, 1,1,1, 2,...]."""
    return torch.cat([torch.full((2 * b + 1,), float(b), device=device)
                      for b in range(deg + 1)])


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor,
            active_degree=None) -> torch.Tensor:
    """``sh`` [..., C, (deg+1)**2] x ``dirs`` [..., 3] -> [..., C].

    ``active_degree`` masks the bands above it (the SH-degree ramp of the
    reference train.py:115-116); masked coefficients get zero gradients.
    """
    basis = eval_sh_basis(deg, dirs)
    if active_degree is not None:
        basis = basis * (band_index(deg, dirs.device) <= active_degree)
    k = (deg + 1) ** 2
    return (sh[..., :k] * basis[..., None, :]).sum(-1)


def sh_to_rgb_clamped(deg: int, sh: torch.Tensor, dirs: torch.Tensor,
                      active_degree=None) -> torch.Tensor:
    """SH -> RGB with the +0.5 offset and the clamp at 0 of the rasterizer
    (``computeColorFromSH``, forward.cu:20-71)."""
    return torch.clamp(eval_sh(deg, sh, dirs, active_degree) + 0.5, min=0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def rotation_between_z(vec: torch.Tensor) -> torch.Tensor:
    """Rotation matrix aligning +z to ``vec`` [..., 3] -> [..., 3, 3]
    (``rotation_between_z``, utils/sh_utils.py:36-68), including the
    -identity fallback when vec_z == -1."""
    v1 = -vec[..., 1]
    v2 = vec[..., 0]
    v11, v22, v12 = v1 * v1, v2 * v2, v1 * v2
    cos_p_1 = torch.clamp(vec[..., 2] + 1, min=1e-7)
    R = torch.stack([
        torch.stack([1 + (-v22) / cos_p_1, v12 / cos_p_1, v2], -1),
        torch.stack([v12 / cos_p_1, 1 + (-v11) / cos_p_1, -v1], -1),
        torch.stack([-v2, v1, 1 + (-v22 - v11) / cos_p_1], -1),
    ], dim=-2)
    flip = (vec[..., 2] + 1 > 0)[..., None, None]
    return torch.where(flip, R, -torch.eye(3, dtype=vec.dtype,
                                           device=vec.device))
