"""Camera model: a plain dataclass of tensors.

Mirrors ``svgir_tpu.cameras``: matrices in math convention
(``p_view = W2C @ [p;1]``, ``clip = FULL @ [p;1]``), image-space convention
``pix = ((ndc + 1) * S - 1) / 2`` (svgss auxiliary.h:42-46).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from reference.utils.graphics import (
    fov2focal,
    projection_matrix,
    projection_matrix_center_shift,
    world_to_view,
)


@dataclass(frozen=True)
class Camera:
    """One posed view.  Tensors live on one device; H/W/fov are Python."""

    world_view: torch.Tensor       # [4, 4] W2C, math convention
    full_proj: torch.Tensor        # [4, 4] P @ W2C
    camera_center: torch.Tensor    # [3]
    prcppoint: torch.Tensor        # [2] principal point in [0,1]
    height: int
    width: int
    fovx: float
    fovy: float
    znear: float = 0.01
    zfar: float = 100.0
    uid: int = 0
    image_name: str = ""
    image: Optional[torch.Tensor] = None        # [3, H, W] in [0,1]
    image_mask: Optional[torch.Tensor] = None   # [1, H, W]
    depth: Optional[torch.Tensor] = None        # [1, H, W]
    normal: Optional[torch.Tensor] = None       # [3, H, W]
    mono: Optional[torch.Tensor] = None         # [4, H, W]

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fovy, self.height)

    def world_directions(self) -> torch.Tensor:
        """Unit world-space ray directions per pixel, [3, H, W]
        (cameras.py:96-108)."""
        kw = dict(dtype=self.world_view.dtype, device=self.device)
        v, u = torch.meshgrid(torch.arange(self.height, **kw),
                              torch.arange(self.width, **kw), indexing="ij")
        dirs = torch.stack([(u - self.width / 2) / self.focal_x,
                            (v - self.height / 2) / self.focal_y,
                            torch.ones_like(u)], dim=0)
        dirs = dirs / torch.linalg.norm(dirs, dim=0, keepdim=True)
        c2w_rot = self.world_view[:3, :3].T
        return (c2w_rot @ dirs.reshape(3, -1)).reshape(3, self.height,
                                                       self.width)


def _tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                fx: Optional[float] = None, fy: Optional[float] = None,
                cx: Optional[float] = None, cy: Optional[float] = None,
                image=None, image_mask=None, depth=None, normal=None,
                mono=None, znear: float = 0.01, zfar: float = 100.0,
                uid: int = 0, image_name: str = "",
                device="cuda") -> Camera:
    """Build a Camera from COLMAP-style extrinsics (scene/cameras.py:9-84).
    Matrices are formed on the host in float32, as ``svgir_tpu`` does, then
    placed on ``device``."""
    w2c = world_to_view(R, T)
    if fx is None:
        proj = projection_matrix(znear, zfar, fovx, fovy)
    else:
        proj = projection_matrix_center_shift(znear, zfar, cx, cy, fx, fy,
                                              width, height)
    full = proj @ w2c
    center = np.linalg.inv(w2c)[:3, 3]
    if image is not None and image_mask is None:
        image_mask = np.ones((1, height, width), np.float32)
    return Camera(
        world_view=_tensor(w2c, device),
        full_proj=_tensor(full, device),
        camera_center=_tensor(center, device),
        prcppoint=_tensor([0.5, 0.5], device),
        height=height, width=width, fovx=fovx, fovy=fovy,
        znear=znear, zfar=zfar, uid=uid, image_name=image_name,
        image=_tensor(image, device), image_mask=_tensor(image_mask, device),
        depth=_tensor(depth, device), normal=_tensor(normal, device),
        mono=_tensor(mono, device))


def look_at_camera(eye, target, up, fovx: float, fovy: float,
                   width: int, height: int, **kw) -> Camera:
    """Camera looking at ``target`` from ``eye`` (OpenCV convention: +z
    forward, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)   # camera-to-world rotation
    T = -R.T @ eye                              # w2c translation
    return make_camera(R.astype(np.float32), T.astype(np.float32),
                       fovx, fovy, width, height, **kw)
