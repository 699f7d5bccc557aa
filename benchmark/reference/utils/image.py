"""Image-space geometry helpers: depth -> normal, normal -> curvature.

Reference: ``utils/image_utils.py:61-141`` via ``svgir_tpu.utils.image``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.utils.graphics import fov2focal
from reference.utils.transforms import normalize


def _pad_edge_hw(x: torch.Tensor) -> torch.Tensor:
    """Replicate-pad an [H, W, C] tensor by one pixel on H and W."""
    return F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1),
                 mode="replicate")[0].permute(1, 2, 0)


def depth_to_campos(depth: torch.Tensor, camera) -> torch.Tensor:
    """Depth [1, H, W] -> camera-space positions [H, W, 3] (fx with x, fy
    with y, as ``svgir_tpu``)."""
    h, w = depth.shape[1], depth.shape[2]
    d = depth[0]
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    px = (uu - camera.prcppoint[0] * camera.width) * d
    py = (vv - camera.prcppoint[1] * camera.height) * d
    fx = fov2focal(camera.fovx, camera.width)
    fy = fov2focal(camera.fovy, camera.height)
    return torch.stack([px / fx, py / fy, d], -1)


def depth2normal(depth: torch.Tensor, mask: torch.Tensor,
                 camera) -> torch.Tensor:
    """Pseudo-normal from depth: [1, H, W] depth and mask -> [3, H, W] unit
    camera-space normals (masked)."""
    campos = depth_to_campos(depth, camera)
    m = (mask[0] != 0)[..., None].to(depth.dtype)
    p = _pad_edge_hw(campos)
    mm = _pad_edge_hw(m)
    p_c = p[1:-1, 1:-1] * mm[1:-1, 1:-1]
    p_u = (p[:-2, 1:-1] - p_c) * mm[:-2, 1:-1]
    p_l = (p[1:-1, :-2] - p_c) * mm[1:-1, :-2]
    p_b = (p[2:, 1:-1] - p_c) * mm[2:, 1:-1]
    p_r = (p[1:-1, 2:] - p_c) * mm[1:-1, 2:]
    cross = torch.linalg.cross
    n = (cross(p_u, p_l) + cross(p_r, p_u) + cross(p_b, p_r)
         + cross(p_l, p_b))
    n = normalize(n) * m
    return n.permute(2, 0, 1)
