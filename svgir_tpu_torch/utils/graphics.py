"""Camera matrices (host numpy, math convention: column vectors,
``P @ W2C @ [p;1]``), hemisphere sampling and the sRGB transforms, as in
``svgir_tpu.utils.graphics``.

Reference: ``utils/graphics_utils.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from svgir_tpu_torch.utils.sh import rotation_between_z
from svgir_tpu_torch.utils.transforms import normalize


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """W2C 4x4 from COLMAP-style R (cam->world rotation) and t (w2c
    translation); ``getWorld2View2`` with zero translate and unit scale."""
    Rt = np.zeros((4, 4), dtype=np.float32)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """GL-style projection (graphics_utils.py:148-168)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def projection_matrix_center_shift(znear: float, zfar: float, cx: float,
                                   cy: float, fx: float, fy: float, w: int,
                                   h: int) -> np.ndarray:
    """Principal-point-shift projection (graphics_utils.py:171-189)."""
    top = cy / fy * znear
    bottom = -(h - cy) / fy * znear
    left = -(w - cx) / fx * znear
    right = cx / fx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def fibonacci_sphere_sampling(normals: torch.Tensor, sample_num: int,
                              azimuth: Optional[torch.Tensor] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hemisphere fibonacci-spiral sampling around unit ``normals`` [N, 3]
    (graphics_utils.py:9-37): z clamped to >= sin(10 deg), area weight
    2*pi.  ``azimuth`` [N, 1], uniform in [0, 1), rotates each point's
    spiral by ``2*pi*azimuth`` (the training-time random offset; the
    caller draws it).  Returns incident_dirs [N, S, 3], areas [N, S, 1]."""
    dev = normals.device
    delta = math.pi * (3.0 - math.sqrt(5.0))
    idx = torch.arange(sample_num, dtype=torch.float32, device=dev)[None]
    z = torch.clamp(1 - 2 * idx / (2 * sample_num - 1),
                    min=math.sin(10 / 180 * math.pi))
    rad = torch.sqrt(1 - z ** 2)
    theta = delta * idx
    if azimuth is not None:
        theta = azimuth * 2 * math.pi + theta                   # [N, S]
    y = torch.cos(theta) * rad
    x = torch.sin(theta) * rad
    z_samples = torch.stack(torch.broadcast_tensors(x, y, z), dim=-2)
    dirs = rotation_between_z(normals) @ z_samples              # [N, 3, S]
    dirs = normalize(dirs, dim=-2).transpose(-1, -2)            # [N, S, 3]
    areas = torch.full(dirs.shape[:-1] + (1,), 2 * math.pi, device=dev)
    return dirs, areas


def rgb_to_srgb(img: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """Linear -> sRGB (graphics_utils.py:198-215), any channel layout."""
    out = torch.where(
        img > 0.0031308,
        torch.pow(torch.clamp(img, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * img)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def srgb_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear (graphics_utils.py:218-231)."""
    return torch.where(
        img <= 0.04045, img / 12.92,
        torch.pow((torch.clamp(img, min=0.04045) + 0.055) / 1.055, 2.4))
