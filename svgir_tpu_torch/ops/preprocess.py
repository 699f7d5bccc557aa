"""Per-Gaussian rasterization preprocess: projection, culls, EWA cov2D,
local homography, radius, tile rect and SH -> RGB.

Reference: svgss ``forward.cu preprocessCUDA`` (:228-396) and
``auxiliary.h``; the math and the order of operations follow
``svgir_tpu.ops.preprocess``.  Culled Gaussians carry ``valid = False``
instead of an early return, with every division guarded so masked lanes
never produce NaN/Inf that could leak through the backward.

``preprocess`` is one autograd Function.  On CUDA tensors it launches
the kernel pair of ``csrc/preprocess.cu`` (P1), whose wrappers refuse
anything but float32; on CPU tensors it runs the plain version: ``preprocess_forward_plain`` (the arithmetic,
in plain tensor ops; autograd can differentiate it) and
``preprocess_backward_plain`` (the hand-derived backward, written as the
kernel computes it).  Either way the backward reads only the forward's
inputs again: nothing of the forward's [N, .] intermediates is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.kernels import preprocess as KP
from svgir_tpu_torch.ops import common
from svgir_tpu_torch.utils import profiling
from svgir_tpu_torch.utils import sh as sh_utils
from svgir_tpu_torch.utils.transforms import quat_to_rotmat


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


# the fields that take a gradient, in the order of the backward's
# cotangents
FLOAT_FIELDS = ("mean2d", "depth", "conic", "normal_view", "jinv", "lam",
                "rgb", "view_cos")
INT_FIELDS = ("valid", "radius", "rect_min", "rect_max", "tiles_touched")
_FLOAT_AT = tuple(Preprocessed._fields.index(f) for f in FLOAT_FIELDS)
_INT_AT = tuple(Preprocessed._fields.index(f) for f in INT_FIELDS)

S_FIX = 1000.0           # local_homo's offset of 1/S_FIX screen units
GRAZING = 0.01           # local_homo's grazing threshold
LOWPASS = 0.3            # the EWA covariance's screen-space dilation, px^2


def _tile_coord(v: torch.Tensor, tile: int, grid: int) -> torch.Tensor:
    """``clip(int32(v / tile), 0, grid)``.  The cast truncates toward zero,
    as ``astype(int32)`` does in the reference (never ``floor``); the
    pre-clamp keeps far-off values inside int32 before the cast."""
    q = torch.clamp(v / tile, -2.0 ** 30, 2.0 ** 30)
    return torch.clamp(q.to(torch.int32), 0, grid)


@profiling.span("svgir.preprocess")
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
    """The preprocess of one camera.  Gradients reach ``means3d``,
    ``scales``, ``quats`` and the colour source (``colors``, else ``shs``);
    the camera takes none, and a camera tensor that asks for one is
    refused.  On CUDA tensors the kernel pair P1 (float32 only), on CPU
    tensors the plain version."""
    for name, t in (("world_view", world_view), ("full_proj", full_proj),
                    ("campos", campos)):
        if t.requires_grad:
            raise ValueError(f"preprocess: {name} takes no gradient")
    mark = profiling.layer("svgir.preprocess")
    kw = dict(width=width, height=height, tanfovx=tanfovx, tanfovy=tanfovy,
              focal_x=focal_x, focal_y=focal_y, sh_degree=sh_degree,
              active_sh_degree=active_sh_degree,
              scale_modifier=scale_modifier, cfg=cfg)
    if colors is not None:
        shs = None
    means3d, scales, quats, shs, colors, world_view, full_proj = (
        None if t is None else t.contiguous() for t in (
            means3d, scales, quats, shs, colors, world_view, full_proj))
    out = _Preprocess.apply(means3d, scales, quats, shs, colors, world_view,
                            full_proj, campos, kw)
    return profiling.layer_out(mark, Preprocessed(*out))


def _kernel_kw(kw, shs, colors) -> dict:
    cfg = kw["cfg"]
    color = "colors" if colors is not None else \
        "sh" if shs is not None else "none"
    return dict(width=kw["width"], height=kw["height"],
                tanfovx=kw["tanfovx"], tanfovy=kw["tanfovy"],
                focal_x=kw["focal_x"], focal_y=kw["focal_y"], tile=cfg.tile,
                surface=cfg.surface, per_pixel_depth=cfg.per_pixel_depth,
                color=color, sh_degree=kw["sh_degree"],
                active_sh_degree=kw["active_sh_degree"],
                scale_modifier=kw["scale_modifier"])


class _Preprocess(torch.autograd.Function):
    """``preprocess``: P1 on CUDA tensors, the plain version on CPU
    tensors.  Saves the inputs only; the backward recomputes the rest.
    Outputs no gradient reaches come to the backward as None (grads are
    not materialized), and the kernel reads no cotangent for them."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, shs, colors, world_view,
                full_proj, campos, kw):
        ctx.set_materialize_grads(False)
        ins = (means3d, scales, quats, shs, colors, world_view, full_proj,
               campos)
        ctx.save_for_backward(*ins)
        ctx.kw = kw
        if common.on_cuda(means3d):
            out = KP.preprocess_forward(
                means3d, scales, quats, world_view, full_proj, campos,
                colors if colors is not None else shs,
                **_kernel_kw(kw, shs, colors))
        else:
            out = tuple(preprocess_forward_plain(
                means3d, scales, quats, world_view, full_proj, campos,
                shs=shs, colors=colors, **kw))
        ctx.mark_non_differentiable(*(out[i] for i in _INT_AT))
        return out

    @staticmethod
    def backward(ctx, *grads):
        means3d, scales, quats, shs, colors, world_view, full_proj, campos \
            = ctx.saved_tensors
        cot = [None if grads[i] is None else grads[i].contiguous()
               for i in _FLOAT_AT]
        if common.on_cuda(means3d):
            d_m, d_s, d_q, d_src = KP.preprocess_backward(
                means3d, scales, quats, world_view, full_proj, campos,
                colors if colors is not None else shs, cot,
                **_kernel_kw(ctx.kw, shs, colors))
            d_shs, d_colors = (None, d_src) if colors is not None \
                else (d_src, None)
        else:
            d_m, d_s, d_q, d_shs, d_colors = preprocess_backward_plain(
                means3d, scales, quats, world_view, full_proj, campos, cot,
                shs=shs, colors=colors, **ctx.kw)
        return d_m, d_s, d_q, d_shs, d_colors, None, None, None, None


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def preprocess_forward_plain(
    means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
    world_view: torch.Tensor, full_proj: torch.Tensor, campos: torch.Tensor,
    *, width: int, height: int, tanfovx: float, tanfovy: float,
    focal_x: float, focal_y: float, shs: Optional[torch.Tensor] = None,
    sh_degree: int = 3, active_sh_degree=None,
    colors: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
    cfg: RasterConfig = RasterConfig(),
) -> Preprocessed:
    """The preprocess in plain tensor ops, on the inputs' device and in
    their dtype; autograd differentiates it where its inputs ask.  The
    arithmetic P1's forward follows, operation for operation, where an
    integer output depends on it."""
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
    return torch.stack([cov[:, 0, 0] + LOWPASS, cov[:, 0, 1],
                        cov[:, 1, 1] + LOWPASS], -1)


def _local_homo(p_view, n_view, fx: float, fy: float, ax0, ax1):
    """Screen-unit -> tangent-plane differential map (auxiliary.h local_homo
    :291-388).  Returns (jinv [N, 10] = [J0 J1 J2 J3, u0(3), u1(3)],
    grazing [N] bool)."""
    svp = (fx + fy) / 2.0
    pz = torch.where(p_view[:, 2] == 0, torch.full_like(p_view[:, 2], 1e-6),
                     p_view[:, 2])
    prj_xy = p_view[:, :2] / pz[:, None]

    def unit_dir(offset_axis):
        cols = [prj_xy[:, 0], prj_xy[:, 1], torch.ones_like(pz)]
        cols[offset_axis] = cols[offset_axis] + 1.0 / S_FIX
        d = torch.stack(cols, -1)
        mod = torch.clamp(d.norm(dim=-1), min=1e-8)
        return d / mod[:, None], mod

    dir_x0, mod0 = unit_dir(0)
    dir_x1, mod1 = unit_dir(1)

    prj_x0 = (dir_x0 * n_view).sum(-1)
    prj_x1 = (dir_x1 * n_view).sum(-1)
    grazing = (((prj_x0 / mod0).abs() < GRAZING)
               | ((prj_x1 / mod1).abs() < GRAZING))

    t_temp = (p_view * n_view).sum(-1)
    prj_x0s = torch.where(prj_x0 == 0, torch.full_like(prj_x0, 1e-8), prj_x0)
    prj_x1s = torch.where(prj_x1 == 0, torch.full_like(prj_x1, 1e-8), prj_x1)
    xu0 = dir_x0 * (t_temp / prj_x0s)[:, None] - p_view
    xu1 = dir_x1 * (t_temp / prj_x1s)[:, None] - p_view

    scale_back = svp / S_FIX
    j0 = (xu0 * ax0).sum(-1) / scale_back
    j1 = (xu1 * ax0).sum(-1) / scale_back
    j2 = (xu0 * ax1).sum(-1) / scale_back
    j3 = (xu1 * ax1).sum(-1) / scale_back
    jinv = torch.cat([torch.stack([j0, j1, j2, j3], -1), ax0, ax1], -1)
    return jinv, grazing


def _dot(a, b):
    return (a * b).sum(-1)


def _inside(x, lo, hi):
    """Where ``torch.clamp(x, lo, hi)`` passes its gradient."""
    return (x >= lo) & (x <= hi)


def _sh_basis_backward(deg: int, d: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """The gradient at unit directions ``d`` [R, 3] of sum_k g_k basis_k,
    basis ``utils.sh.eval_sh_basis(deg, d)``; ``g`` [R, (deg+1)**2]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    gz = torch.zeros_like(x)
    C1, C2, C3, C4 = sh_utils.C1, sh_utils.C2, sh_utils.C3, sh_utils.C4
    if deg > 0:
        gy = gy - C1 * g[:, 1]
        gz = gz + C1 * g[:, 2]
        gx = gx - C1 * g[:, 3]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        g4, g5, g6, g7, g8 = (g[:, k] for k in range(4, 9))
        gx = gx + C2[0] * y * g4 + C2[3] * z * g7 \
            + 2 * x * (C2[4] * g8 - C2[2] * g6)
        gy = gy + C2[0] * x * g4 + C2[1] * z * g5 \
            - 2 * y * (C2[2] * g6 + C2[4] * g8)
        gz = gz + C2[1] * y * g5 + 4 * C2[2] * z * g6 + C2[3] * x * g7
    if deg > 2:
        g9, g10, g11, g12, g13, g14, g15 = (g[:, k] for k in range(9, 16))
        gx = gx + (C3[0] * 6 * x * y * g9 + C3[1] * y * z * g10
                   - C3[2] * 2 * x * y * g11 - C3[3] * 6 * x * z * g12
                   + C3[4] * (4 * zz - 3 * xx - yy) * g13
                   + C3[5] * 2 * x * z * g14
                   + C3[6] * 3 * (xx - yy) * g15)
        gy = gy + (C3[0] * 3 * (xx - yy) * g9 + C3[1] * x * z * g10
                   + C3[2] * (4 * zz - xx - 3 * yy) * g11
                   - C3[3] * 6 * y * z * g12 - C3[4] * 2 * x * y * g13
                   - C3[5] * 2 * y * z * g14 - C3[6] * 6 * x * y * g15)
        gz = gz + (C3[1] * x * y * g10 + C3[2] * 8 * y * z * g11
                   + C3[3] * (6 * zz - 3 * xx - 3 * yy) * g12
                   + C3[4] * 8 * x * z * g13 + C3[5] * (xx - yy) * g14)
    if deg > 3:
        g16, g17, g18, g19, g20, g21, g22, g23, g24 = (
            g[:, k] for k in range(16, 25))
        z7a, z7b = 7 * zz - 1, 7 * zz - 3
        gx = gx + (C4[0] * y * (3 * xx - yy) * g16
                   + C4[1] * 6 * x * y * z * g17 + C4[2] * y * z7a * g18
                   + C4[5] * z * z7b * g21 + C4[6] * 2 * x * z7a * g22
                   + C4[7] * 3 * z * (xx - yy) * g23
                   + C4[8] * 4 * x * (xx - 3 * yy) * g24)
        gy = gy + (C4[0] * x * (xx - 3 * yy) * g16
                   + C4[1] * 3 * z * (xx - yy) * g17
                   + C4[2] * x * z7a * g18 + C4[3] * z * z7b * g19
                   - C4[6] * 2 * y * z7a * g22
                   - C4[7] * 6 * x * y * z * g23
                   + C4[8] * 4 * y * (yy - 3 * xx) * g24)
        gz = gz + (C4[1] * y * (3 * xx - yy) * g17
                   + C4[2] * 14 * x * y * z * g18
                   + C4[3] * y * (21 * zz - 3) * g19
                   + C4[4] * z * (140 * zz - 60) * g20
                   + C4[5] * x * (21 * zz - 3) * g21
                   + C4[6] * 14 * z * (xx - yy) * g22
                   + C4[7] * x * (xx - 3 * yy) * g23)
    return torch.stack([gx, gy, gz], -1)


def _rotmat_backward(q: torch.Tensor, dR: torch.Tensor) -> torch.Tensor:
    """``quat_to_rotmat``'s backward: [R, 4] from dR [R, 3, 3], through
    the normalization (``utils.transforms.normalize``: its second term
    only where the clamp of |q|^2 passes)."""
    sq = (q * q).sum(-1, keepdim=True)
    rinv = torch.rsqrt(torch.clamp(sq, min=1e-24))
    r, x, y, z = (q * rinv).unbind(-1)
    d = dR.reshape(-1, 9)
    d00, d01, d02, d10, d11, d12, d20, d21, d22 = d.unbind(-1)
    dqn = 2 * torch.stack([
        z * (d10 - d01) + y * (d02 - d20) + x * (d21 - d12),
        y * (d01 + d10) + z * (d02 + d20) + r * (d21 - d12)
        - 2 * x * (d11 + d22),
        x * (d01 + d10) + z * (d12 + d21) + r * (d02 - d20)
        - 2 * y * (d00 + d22),
        x * (d02 + d20) + y * (d12 + d21) + r * (d10 - d01)
        - 2 * z * (d00 + d11)], -1)
    c = torch.where(sq >= 1e-24, (dqn * q).sum(-1, keepdim=True)
                    * rinv * rinv * rinv, torch.zeros_like(sq))
    return dqn * rinv - q * c


def _zero_or(g, shape, like):
    return like.new_zeros(shape) if g is None else g


def preprocess_backward_plain(
    means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
    world_view: torch.Tensor, full_proj: torch.Tensor, campos: torch.Tensor,
    cotangents: Sequence[Optional[torch.Tensor]], *, width: int,
    height: int, tanfovx: float, tanfovy: float, focal_x: float,
    focal_y: float, shs: Optional[torch.Tensor] = None, sh_degree: int = 3,
    active_sh_degree=None, colors: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0, cfg: RasterConfig = RasterConfig(),
):
    """The plain version of ``svgir_preprocess_backward``: the hand-derived
    backward of ``preprocess_forward_plain``, as autograd takes it there
    (``torch.where`` passes nothing to the branch not taken, a clamp passes
    its gradient where min <= x <= max, the rgb clamp at 0 and the bands
    above ``active_sh_degree`` pass zero).  ``cotangents``: the gradients
    of ``FLOAT_FIELDS`` in that order, each None where none reaches it.
    Returns (d_means3d, d_scales, d_quats, d_shs, d_colors): d_shs where
    ``shs`` is the colour source, d_colors where ``colors`` is, else
    None."""
    if colors is not None:
        shs = None
    n = means3d.shape[0]
    g_m2d, g_depth, g_conic, g_nv, g_jinv, g_lam, g_rgb, g_vc = [
        _zero_or(g, shape, means3d) for g, shape in zip(
            cotangents, ((n, 2), (n,), (n, 3), (n, 3), (n, 10), (n, 2),
                         (n, 3), (n,)))]
    d_shs = None
    with torch.no_grad():
        d_m, d_s, d_q = _geometry_backward(
            means3d, scales, quats, world_view, full_proj, g_m2d, g_depth,
            g_conic, g_nv, g_jinv, g_lam, g_vc, width=width, height=height,
            tanfovx=tanfovx, tanfovy=tanfovy, focal_x=focal_x,
            focal_y=focal_y, scale_modifier=scale_modifier, cfg=cfg)
        if shs is not None:
            d_shs, d_m_sh = _sh_backward(means3d, campos, shs, sh_degree,
                                         active_sh_degree, g_rgb)
            d_m = d_m_sh + d_m
    return d_m, d_s, d_q, d_shs, None if colors is None else g_rgb


def _sh_backward(means3d, campos, shs, deg, active, g_rgb):
    """(d_shs, the SH's share of d_means3d)."""
    n, kk = shs.shape[0], (deg + 1) ** 2
    raw = means3d - campos[None]
    nrm = raw.norm(dim=-1, keepdim=True)
    nc = torch.clamp(nrm, min=1e-12)
    dirs = raw / nc
    basis = sh_utils.eval_sh_basis(deg, dirs)
    if active is not None:
        basis = basis * (sh_utils.band_index(deg, dirs.device) <= active)
    sh_t = shs.transpose(-1, -2)[..., :kk]                 # [N, 3, kk]
    v = (sh_t * basis[:, None, :]).sum(-1)
    gv = torch.where(v + 0.5 >= 0, g_rgb, torch.zeros_like(g_rgb))
    d_shs = torch.zeros_like(shs)
    d_shs[:, :kk] = basis[:, :, None] * gv[:, None, :]
    d_basis = (gv[:, :, None] * sh_t).sum(1)
    if active is not None:
        d_basis = d_basis * (sh_utils.band_index(deg, dirs.device) <= active)
    d_dirs = _sh_basis_backward(deg, dirs, d_basis)
    d_nc = -_dot(d_dirs, raw)[:, None] / (nc * nc)
    d_raw = d_dirs / nc + torch.where(
        nrm >= 1e-12, d_nc * raw / torch.where(nrm > 0, nrm, 1.0),
        torch.zeros_like(raw))
    return d_shs, d_raw


def _geometry_backward(means3d, scales, quats, world_view, full_proj,
                       g_m2d, g_depth, g_conic, g_nv, g_jinv, g_lam, g_vc,
                       *, width, height, tanfovx, tanfovy, focal_x, focal_y,
                       scale_modifier, cfg):
    """(the geometry's share of d_means3d, d_scales, d_quats)."""
    n = means3d.shape[0]
    zero = means3d.new_zeros(())
    fx, fy = focal_x, focal_y
    W = world_view[:3, :3]

    # ---- the forward again ------------------------------------------------
    hom = torch.cat([means3d, means3d.new_ones(n, 1)], -1)
    p_hom = hom @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    pv = (hom @ world_view.T)[:, :3]
    R = quat_to_rotmat(quats)
    nv = R[..., :, 2] @ W.T
    ax0 = R[..., :, 0] @ W.T
    ax1 = R[..., :, 1] @ W.T
    s = scales * scale_modifier
    if cfg.surface:
        s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], -1)
    M = R * s[:, None, :]

    d_pv = torch.zeros_like(pv)
    d_nv = g_nv.clone()
    d_ax0 = g_jinv[:, 4:7].clone()
    d_ax1 = g_jinv[:, 7:10].clone()
    d_s = torch.zeros_like(s)
    d_s[:, :2] = g_lam

    # ---- mean2d = ((p_hom[:2] p_w + 1) size - 1) / 2 -----------------------
    d_pp = g_m2d * 0.5 * torch.tensor([float(width), float(height)],
                                      dtype=g_m2d.dtype, device=g_m2d.device)
    d_pw = _dot(d_pp, p_hom[:, :2])
    d_ph = torch.cat([d_pp * p_w[:, None], torch.zeros_like(p_w[:, None]),
                      (-d_pw * p_w * p_w)[:, None]], -1)
    d_m = d_ph @ full_proj[:, :3]

    # ---- depth and view_cos -------------------------------------------------
    d_pv[:, 2] = d_pv[:, 2] + g_depth
    d_pv = d_pv + g_vc[:, None] * nv
    d_nv = d_nv + g_vc[:, None] * pv

    # ---- local homography ---------------------------------------------------
    pz = torch.where(pv[:, 2] == 0, torch.full_like(pv[:, 2], 1e-6),
                     pv[:, 2])
    prj = pv[:, :2] / pz[:, None]
    one = torch.ones_like(pz)
    d0 = torch.stack([prj[:, 0] + 1.0 / S_FIX, prj[:, 1], one], -1)
    d1 = torch.stack([prj[:, 0], prj[:, 1] + 1.0 / S_FIX, one], -1)
    nrm0, nrm1 = d0.norm(dim=-1), d1.norm(dim=-1)
    mod0 = torch.clamp(nrm0, min=1e-8)
    mod1 = torch.clamp(nrm1, min=1e-8)
    dir0, dir1 = d0 / mod0[:, None], d1 / mod1[:, None]
    p0, p1 = _dot(dir0, nv), _dot(dir1, nv)
    t = _dot(pv, nv)
    p0s = torch.where(p0 == 0, torch.full_like(p0, 1e-8), p0)
    p1s = torch.where(p1 == 0, torch.full_like(p1, 1e-8), p1)
    a0, a1 = t / p0s, t / p1s
    xu0 = dir0 * a0[:, None] - pv
    xu1 = dir1 * a1[:, None] - pv
    sb = (fx + fy) / 2.0 / S_FIX
    gj = g_jinv[:, :4] / sb
    d_xu0 = gj[:, 0:1] * ax0 + gj[:, 2:3] * ax1
    d_xu1 = gj[:, 1:2] * ax0 + gj[:, 3:4] * ax1
    d_ax0 = d_ax0 + gj[:, 0:1] * xu0 + gj[:, 1:2] * xu1
    d_ax1 = d_ax1 + gj[:, 2:3] * xu0 + gj[:, 3:4] * xu1
    d_dir0 = d_xu0 * a0[:, None]
    d_dir1 = d_xu1 * a1[:, None]
    d_a0, d_a1 = _dot(d_xu0, dir0), _dot(d_xu1, dir1)
    d_pv = d_pv - d_xu0 - d_xu1
    d_t = d_a0 / p0s + d_a1 / p1s
    d_p0 = torch.where(p0 != 0, -d_a0 * t / (p0s * p0s), zero)
    d_p1 = torch.where(p1 != 0, -d_a1 * t / (p1s * p1s), zero)
    d_dir0 = d_dir0 + d_p0[:, None] * nv
    d_dir1 = d_dir1 + d_p1[:, None] * nv
    d_nv = d_nv + d_p0[:, None] * dir0 + d_p1[:, None] * dir1
    d_pv = d_pv + d_t[:, None] * nv
    d_nv = d_nv + d_t[:, None] * pv

    def unit_backward(dv, dd, nrm, mod):
        d_mod = -_dot(dd, dv) / (mod * mod)
        d_mod = torch.where(nrm >= 1e-8, d_mod, zero)
        return dd / mod[:, None] + (d_mod / torch.where(
            nrm > 0, nrm, one))[:, None] * dv

    d_d0 = unit_backward(d0, d_dir0, nrm0, mod0)
    d_d1 = unit_backward(d1, d_dir1, nrm1, mod1)
    d_prj = d_d0[:, :2] + d_d1[:, :2]
    d_pz = -_dot(d_prj, pv[:, :2]) / (pz * pz)
    d_pv[:, :2] = d_pv[:, :2] + d_prj / pz[:, None]
    d_pv[:, 2] = d_pv[:, 2] + torch.where(pv[:, 2] != 0, d_pz, zero)

    # ---- EWA covariance and conic -------------------------------------------
    tz = pv[:, 2]
    tzs = torch.where(tz == 0, torch.full_like(tz, 1e-6), tz)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    ux, uy = pv[:, 0] / tzs, pv[:, 1] / tzs
    cx = torch.clamp(ux, -lim_x, lim_x)
    cy = torch.clamp(uy, -lim_y, lim_y)
    tx, ty = cx * tz, cy * tz
    tz2 = tzs * tzs
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tzs, zeros, -fx * tx / tz2], -1),
        torch.stack([zeros, fy / tzs, -fy * ty / tz2], -1)], dim=-2)
    T = J @ W[None]
    cov = T @ (M @ M.transpose(-1, -2)) @ T.transpose(-1, -2)
    c0, c1, c2 = cov[:, 0, 0] + LOWPASS, cov[:, 0, 1], cov[:, 1, 1] + LOWPASS
    det = c0 * c2 - c1 ** 2
    ds_ = torch.where(det == 0, torch.ones_like(det), det)
    gc0, gc1, gc2 = g_conic.unbind(-1)
    d_ds = -(gc0 * c2 - gc1 * c1 + gc2 * c0) / (ds_ * ds_)
    d_det = torch.where(det != 0, d_ds, zero)
    d_c0 = gc2 / ds_ + d_det * c2
    d_c1 = -gc1 / ds_ - 2 * c1 * d_det
    d_c2 = gc0 / ds_ + d_det * c0
    # cov = U U^T, U = T M; autograd's cotangent of cov is [[d_c0, d_c1],
    # [0, d_c2]] (cov[1, 0] is read by no output), symmetrized here
    Gs = torch.stack([torch.stack([2 * d_c0, d_c1], -1),
                      torch.stack([d_c1, 2 * d_c2], -1)], -2)
    U = T @ M
    d_U = Gs @ U
    d_T = d_U @ M.transpose(-1, -2)
    d_M = T.transpose(-1, -2) @ d_U
    d_R = d_M * s[:, None, :]
    d_s = d_s + (d_M * R).sum(1)
    d_J = d_T @ W.T
    rec = 1.0 / tzs
    d_tzs = -(d_J[:, 0, 0] * fx + d_J[:, 1, 1] * fy) * rec * rec
    d_tx = d_J[:, 0, 2] * -fx / tz2
    d_ty = d_J[:, 1, 2] * -fy / tz2
    d_tz2 = -(d_J[:, 0, 2] * J[:, 0, 2] + d_J[:, 1, 2] * J[:, 1, 2]) / tz2
    d_tzs = d_tzs + 2 * tzs * d_tz2
    d_ux = torch.where(_inside(ux, -lim_x, lim_x), d_tx * tz, zero)
    d_uy = torch.where(_inside(uy, -lim_y, lim_y), d_ty * tz, zero)
    d_tz = d_tx * cx + d_ty * cy
    d_pv[:, 0] = d_pv[:, 0] + d_ux / tzs
    d_pv[:, 1] = d_pv[:, 1] + d_uy / tzs
    d_tzs = d_tzs - (d_ux * pv[:, 0] + d_uy * pv[:, 1]) / (tzs * tzs)
    d_pv[:, 2] = d_pv[:, 2] + d_tz + torch.where(tz != 0, d_tzs, zero)

    # ---- orientation, quaternion, scales ------------------------------------
    d_R = d_R + torch.stack([d_ax0 @ W, d_ax1 @ W, d_nv @ W], -1)
    d_q = _rotmat_backward(quats, d_R)
    if cfg.surface:
        d_s[:, 2] = 0
    d_m = d_m + d_pv @ world_view[:3, :3]
    return d_m, d_s * scale_modifier, d_q
