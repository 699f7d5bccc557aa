"""Quaternion / rotation math (batched-first torch tensors).

Contracts follow ``svgir_tpu.utils.transforms``: quaternions are w-first
(reference ``build_rotation``, utils/general_utils.py:82-103) and the
activation inverses are those of scene/gaussian_model.py:104-125.
"""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim`` in the clamped-square rsqrt form, which
    keeps the backward finite at exactly-zero vectors."""
    sq = (v * v).sum(dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]
    (normalized internally)."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (w, x, y, z), w-branch only like the reference
    ``rotation_to_quaternion`` (general_utils.py:105-117)."""
    r11, r22, r33 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1 + r11 + r22 + r33, min=1e-7)) / 2
    qx = (R[..., 2, 1] - R[..., 1, 2]) / (4 * qw)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / (4 * qw)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / (4 * qw)
    return normalize(torch.stack([qw, qx, qy, qz], dim=-1))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def normal_to_rotation(normal: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion whose rotation's 3rd column equals ``normal``."""
    n = normalize(normal)
    z_axis = n.new_tensor([0.0, 0.0, 1.0]).expand_as(n)
    x_axis = n.new_tensor([1.0, 0.0, 0.0]).expand_as(n)
    helper = torch.where(n[..., 2:3].abs() < 0.999, z_axis, x_axis)
    x = normalize(torch.linalg.cross(helper, n), eps=eps)
    y = torch.linalg.cross(n, x)
    R = torch.stack([x, y, n], dim=-1)  # columns
    return rotmat_to_quat(R)


def get_expon_lr_fn(lr_init: float, lr_final: float,
                    lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
                    max_steps: int = 1_000_000):
    """Log-lerp LR schedule with sine delay (general_utils.py:30-63), as a
    host function of the integer step."""
    def helper(step):
        if (lr_init == 0.0 and lr_final == 0.0) or step < 0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        li = math.log(lr_init) if lr_init > 0 else -math.inf
        lf = math.log(lr_final) if lr_final > 0 else -math.inf
        return delay_rate * math.exp(li * (1 - t) + lf * t)

    return helper
