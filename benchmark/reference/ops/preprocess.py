"""Per-Gaussian rasterization preprocess: projection, culls, EWA cov2D,
local homography, radius, tile rect and SH -> RGB.  Plain tensor ops,
differentiated by autograd.

Reference: svgss ``forward.cu preprocessCUDA`` (:228-396) and
``auxiliary.h``; the math and the order of operations follow
``svgir_tpu.ops.preprocess``.  Culled Gaussians carry ``valid = False``
instead of an early return, with every division guarded so masked lanes
never produce NaN/Inf that could leak through the backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.config import RasterConfig
from reference.utils import sh as sh_utils
from reference.utils.transforms import quat_to_rotmat


class Preprocessed(NamedTuple):
    """Per-Gaussian quantities consumed by binning and blending."""

    valid: torch.Tensor      # [N] bool, survives all culls
    mean2d: torch.Tensor     # [N, 2] pixel coords
    depth: torch.Tensor      # [N] view-space z
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (xx, xy, yy)
    radius: torch.Tensor     # [N] int32 screen radius (0 if culled)
    rect_min: torch.Tensor   # [N, 2] int32 tile coords (x, y)
    rect_max: torch.Tensor   # [N, 2] int32 tile coords (exclusive)
    tiles_touched: torch.Tensor  # [N] int32
    normal_view: torch.Tensor    # [N, 3] view-space geometric normal
    jinv: torch.Tensor       # [N, 10] screen->tangent map + tangent axes
    lam: torch.Tensor        # [N, 2] scale.xy
    rgb: torch.Tensor        # [N, 3] SH-evaluated color
    view_cos: torch.Tensor   # [N] dot(p_view, n_view)


def _tile_coord(v: torch.Tensor, tile: int, grid: int) -> torch.Tensor:
    """``clip(int32(v / tile), 0, grid)``.  The cast truncates toward zero,
    as ``astype(int32)`` does in the reference (never ``floor``); the
    pre-clamp keeps far-off values inside int32 before the cast."""
    q = torch.clamp(v / tile, -2.0 ** 30, 2.0 ** 30)
    return torch.clamp(q.to(torch.int32), 0, grid)


def preprocess(
    means3d: torch.Tensor,          # [N, 3]
    scales: torch.Tensor,           # [N, 3]
    quats: torch.Tensor,            # [N, 4] w-first
    world_view: torch.Tensor,       # [4, 4]
    full_proj: torch.Tensor,        # [4, 4]
    campos: torch.Tensor,           # [3]
    *,
    width: int,
    height: int,
    tanfovx: float,
    tanfovy: float,
    focal_x: float,
    focal_y: float,
    shs: Optional[torch.Tensor] = None,     # [N, K, 3]
    sh_degree: int = 3,
    active_sh_degree=None,
    colors: Optional[torch.Tensor] = None,  # [N, 3]
    scale_modifier: float = 1.0,
    cfg: RasterConfig = RasterConfig(),
) -> Preprocessed:
    n = means3d.shape[0]
    tile = cfg.tile
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile

    # ---- projection (forward.cu:277-285) ----------------------------------
    hom = torch.cat([means3d, means3d.new_ones(n, 1)], -1)
    p_hom = hom @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    p_view = (hom @ world_view.T)[:, :3]

    px = ((p_proj[:, 0] + 1.0) * width - 1.0) * 0.5
    py = ((p_proj[:, 1] + 1.0) * height - 1.0) * 0.5
    mean2d = torch.stack([px, py], -1)

    # ---- frustum cull (auxiliary.h:146-171), full-image bbox ---------------
    bw, bh = float(width), float(height)
    expand = 0.2
    valid = ((p_view[:, 2] >= 0)
             & (px >= -bw * expand) & (px < bw + bw * expand)
             & (py >= -bh * expand) & (py < bh + bh * expand))

    # ---- orientation (forward.cu:287-319) ---------------------------------
    R = quat_to_rotmat(quats)
    W = world_view[:3, :3]
    n_view = R[..., :, 2] @ W.T
    ax0_view = R[..., :, 0] @ W.T
    ax1_view = R[..., :, 1] @ W.T

    view_cos = (p_view * n_view).sum(-1)
    if cfg.surface:
        valid = valid & (view_cos <= -0.01)

    # ---- local homography (auxiliary.h:291-388) ---------------------------
    jinv, grazing = _local_homo(p_view, n_view, focal_x, focal_y,
                                ax0_view, ax1_view)
    if cfg.surface and cfg.per_pixel_depth:
        valid = valid & ~grazing

    # ---- covariance (forward.cu:186-226, 74-139) --------------------------
    s = scales * scale_modifier
    if cfg.surface:
        s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], -1)
    M = R * s[:, None, :]
    cov3d = M @ M.transpose(-1, -2)

    cov2d = _ewa_cov2d(p_view, cov3d, W, focal_x, focal_y, tanfovx, tanfovy)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    valid = valid & (det != 0.0)
    det_safe = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]],
                        -1) / det_safe[:, None]

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    # ---- tile rect (auxiliary.h:53-63) ------------------------------------
    with torch.no_grad():
        rmin_x = _tile_coord(px - radius, tile, grid_x)
        rmin_y = _tile_coord(py - radius, tile, grid_y)
        rmax_x = _tile_coord(px + radius + tile - 1, tile, grid_x)
        rmax_y = _tile_coord(py + radius + tile - 1, tile, grid_y)
        tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)
        valid = valid & (tiles_touched > 0)
        radius_i = torch.where(valid, radius, torch.zeros_like(radius)).to(
            torch.int32)
        tiles_touched = torch.where(valid, tiles_touched,
                                    torch.zeros_like(tiles_touched))

    # ---- color (forward.cu:20-71) -----------------------------------------
    if colors is not None:
        rgb = colors
    elif shs is not None:
        dirs = means3d - campos[None]
        dirs = dirs / torch.clamp(dirs.norm(dim=-1, keepdim=True), min=1e-12)
        rgb = sh_utils.sh_to_rgb_clamped(sh_degree, shs.transpose(-1, -2),
                                         dirs, active_degree=active_sh_degree)
    else:
        rgb = means3d.new_zeros(n, 3)

    return Preprocessed(
        valid=valid, mean2d=mean2d, depth=p_view[:, 2], conic=conic,
        radius=radius_i,
        rect_min=torch.stack([rmin_x, rmin_y], -1),
        rect_max=torch.stack([rmax_x, rmax_y], -1),
        tiles_touched=tiles_touched,
        normal_view=n_view, jinv=jinv, lam=s[:, :2],
        rgb=rgb, view_cos=view_cos)


def _ewa_cov2d(p_view, cov3d, W, fx: float, fy: float, tanx: float,
               tany: float) -> torch.Tensor:
    """EWA screen-space covariance (forward.cu computeCov2D :74-139) with
    the +0.3 low-pass dilation: [N, 3] = (xx, xy, yy)."""
    tz = p_view[:, 2]
    tz_safe = torch.where(tz == 0, torch.full_like(tz, 1e-6), tz)
    lim_x, lim_y = 1.3 * tanx, 1.3 * tany
    tx = torch.clamp(p_view[:, 0] / tz_safe, -lim_x, lim_x) * tz
    ty = torch.clamp(p_view[:, 1] / tz_safe, -lim_y, lim_y) * tz
    tz2 = tz_safe * tz_safe

    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz_safe, zeros, -fx * tx / tz2], -1),
        torch.stack([zeros, fy / tz_safe, -fy * ty / tz2], -1),
    ], dim=-2)                                    # [N, 2, 3]
    T = J @ W[None]
    cov = T @ cov3d @ T.transpose(-1, -2)
    return torch.stack([cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3],
                       -1)


def _local_homo(p_view, n_view, fx: float, fy: float, ax0, ax1):
    """Screen-unit -> tangent-plane differential map (auxiliary.h local_homo
    :291-388).  Returns (jinv [N, 10] = [J0 J1 J2 J3, u0(3), u1(3)],
    grazing [N] bool)."""
    s_fix = 1000.0
    svp = (fx + fy) / 2.0
    pz = torch.where(p_view[:, 2] == 0, torch.full_like(p_view[:, 2], 1e-6),
                     p_view[:, 2])
    prj_xy = p_view[:, :2] / pz[:, None]

    def unit_dir(offset_axis):
        cols = [prj_xy[:, 0], prj_xy[:, 1], torch.ones_like(pz)]
        cols[offset_axis] = cols[offset_axis] + 1.0 / s_fix
        d = torch.stack(cols, -1)
        mod = torch.clamp(d.norm(dim=-1), min=1e-8)
        return d / mod[:, None], mod

    dir_x0, mod0 = unit_dir(0)
    dir_x1, mod1 = unit_dir(1)

    prj_x0 = (dir_x0 * n_view).sum(-1)
    prj_x1 = (dir_x1 * n_view).sum(-1)
    thrsh = 0.01
    grazing = ((prj_x0 / mod0).abs() < thrsh) | ((prj_x1 / mod1).abs() < thrsh)

    t_temp = (p_view * n_view).sum(-1)
    prj_x0s = torch.where(prj_x0 == 0, torch.full_like(prj_x0, 1e-8), prj_x0)
    prj_x1s = torch.where(prj_x1 == 0, torch.full_like(prj_x1, 1e-8), prj_x1)
    xu0 = dir_x0 * (t_temp / prj_x0s)[:, None] - p_view
    xu1 = dir_x1 * (t_temp / prj_x1s)[:, None] - p_view

    scale_back = svp / s_fix
    j0 = (xu0 * ax0).sum(-1) / scale_back
    j1 = (xu1 * ax0).sum(-1) / scale_back
    j2 = (xu0 * ax1).sum(-1) / scale_back
    j3 = (xu1 * ax1).sum(-1) / scale_back
    jinv = torch.cat([torch.stack([j0, j1, j2, j3], -1), ax0, ax1], -1)
    return jinv, grazing
