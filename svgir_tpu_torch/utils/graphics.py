"""Camera matrices (host numpy, math convention: column vectors,
``P @ W2C @ [p;1]``), as in ``svgir_tpu.utils.graphics``.

Reference: ``utils/graphics_utils.py``.
"""

from __future__ import annotations

import math

import numpy as np


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
