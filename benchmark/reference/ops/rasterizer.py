"""Reference rasterizer: preprocess -> counting binner -> image-layout blend.

The path of ``svgir_tpu.ops.rasterizer.rasterize`` that the training steps
take (counting binner, ``strip > 0``): ``_BlendGather`` is the
custom-gradient boundary around the per-Gaussian slab gather and the
blend's plain forward and backward (``ops/blend_pallas_strip``), which
scatter-adds the per-instance rows into per-Gaussian rows with
``index_add_``.  Everything else is plain torch differentiated by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.config import RasterConfig
from reference.ops import blend_pallas_strip, common
from reference.ops.binning import bin_instances_counting
from reference.ops.preprocess import Preprocessed, preprocess


class RenderBuffers(NamedTuple):
    color: torch.Tensor      # [3, H, W] (includes T*bg)
    normal: torch.Tensor     # [3, H, W] view-space
    depth: torch.Tensor      # [1, H, W]
    opacity: torch.Tensor    # [1, H, W] 1 - T
    feature: torch.Tensor    # [S, H, W]
    vfeature: torch.Tensor   # [VS/4, H, W]
    final_t: torch.Tensor    # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32
    weights: torch.Tensor    # [N, 1] per-Gaussian blended weight sums
    radii: torch.Tensor      # [N] int32 screen radii (0 = culled)
    overflow: torch.Tensor   # [] bool, the binner hit max_instances


def _gather(slab_rows, gid):
    """Instance slab [M, KR]: padding slots (gid -1) take the zero row n."""
    n = slab_rows.shape[0] - 1
    idx = torch.where(gid >= 0, gid, n).long()
    return idx, slab_rows.index_select(0, idx)


def _gaussian_weights(wsum, idx, n):
    weights = wsum.new_zeros(n + 1)
    weights.index_add_(0, idx, wsum)
    return weights[:n]


def _instance_g_wsum(g_weights, idx):
    """Each instance's weight-sum cotangent: its Gaussian's (0 for
    padding)."""
    g_ext = torch.cat([g_weights, g_weights.new_zeros(1)])
    return g_ext.index_select(0, idx).contiguous()


def _gaussian_rows(d_inst, idx, n):
    """Per-Gaussian rows [n+1, KR]; padding slots land in row n."""
    d_rows = d_inst.new_zeros(n + 1, d_inst.shape[1])
    d_rows.index_add_(0, idx, d_inst)
    return d_rows


class _BlendGather(torch.autograd.Function):
    """(slab_rows [n+1, KR], gid [M]) -> (img, per-Gaussian weights [n]),
    through the image-layout blend B3/B4.

    ``slab_rows`` carries one extra all-zero row ``n``: padding slots
    (gid -1) gather it, and their gradients scatter back into it, so no
    [M, KR] select passes are needed.  ``wgrad=False`` drops the weights
    cotangent (the reference's out_weights buffer is not differentiable);
    ``need_weights=False`` skips the weight sums altogether.
    """

    @staticmethod
    def forward(ctx, slab_rows, gid, tile_start, tile_count, kw, wgrad,
                need_weights):
        n = slab_rows.shape[0] - 1
        idx, slab = _gather(slab_rows, gid)
        img, eff, wsum = blend_pallas_strip.blend_forward(
            slab, tile_start, tile_count, emit_wsum=need_weights, **kw)
        weights = _gaussian_weights(wsum, idx, n) if need_weights \
            else slab_rows.new_zeros(n)
        ctx.save_for_backward(slab, idx, tile_start, img, eff)
        ctx.kw, ctx.wgrad, ctx.n = kw, wgrad, n
        return img, weights

    @staticmethod
    def backward(ctx, g_img, g_weights):
        slab, idx, tile_start, img, eff = ctx.saved_tensors
        kw = ctx.kw
        g_wsum = _instance_g_wsum(g_weights, idx) if ctx.wgrad else None
        d_inst = blend_pallas_strip.blend_backward(
            slab, tile_start, eff, g_img.contiguous(),
            img[kw["ca"] + kw["cv"]], g_wsum, **kw)
        return (_gaussian_rows(d_inst, idx, ctx.n), None, None, None, None,
                None, None)


def _pack_slab(prep: Preprocessed, opacity: torch.Tensor,
               features: Optional[torch.Tensor],
               vfeatures: Optional[torch.Tensor],
               cfg: RasterConfig) -> tuple[torch.Tensor, int, int]:
    """Per-Gaussian slab [N, 12+CA+4CV] (layout in ops/blend_pallas_strip).

    The per-pixel depth correction (forward.cu:563-576) is affine in the
    pixel: depth_px = adepth + px*c1 + py*c2 with c1 = j0*u0z + j2*u1z and
    c2 = j1*u0z + j3*u1z, folded into three plain channels.
    """
    n = prep.mean2d.shape[0]
    x, y = prep.mean2d[:, 0], prep.mean2d[:, 1]
    j = prep.jinv
    if cfg.surface and cfg.per_pixel_depth:
        c1 = j[:, 0] * j[:, 6] + j[:, 2] * j[:, 9]
        c2 = j[:, 1] * j[:, 6] + j[:, 3] * j[:, 9]
    else:
        c1 = torch.zeros_like(x)
        c2 = torch.zeros_like(x)
    adepth = prep.depth - x * c1 - y * c2

    geom = torch.stack([x, y, prep.conic[:, 0], prep.conic[:, 1],
                        prep.conic[:, 2], opacity,
                        j[:, 0], j[:, 1], j[:, 2], j[:, 3],
                        prep.lam[:, 0], prep.lam[:, 1]], -1)
    plain = [prep.rgb, prep.normal_view, adepth[:, None], c1[:, None],
             c2[:, None]]
    if features is not None:
        plain.append(features)
    plain = torch.cat(plain, -1)
    ca = plain.shape[1]

    if vfeatures is not None:
        cv = vfeatures.shape[1] // 4
        # channel-major storage [c0v0 c0v1 c0v2 c0v3 c1v0 ...] -> v-major
        vcols = vfeatures.reshape(n, cv, 4).transpose(1, 2).reshape(n, 4 * cv)
    else:
        cv = 0
        vcols = geom.new_zeros(n, 0)
    return torch.cat([geom, plain, vcols], -1), ca, cv


def _clamp_runs(padded, m: int, chunk: int):
    """The binner's tile runs, cut at the instance buffer's end: on
    overflow they reach past it, and the blend must read no row past M
    (the dropped instances are lost for this frame, as the overflow flag
    reports)."""
    tile_start = torch.clamp(padded.tile_start, max=m)
    tile_count = torch.minimum(padded.tile_count,
                               (m - tile_start) // chunk * chunk)
    return tile_start, tile_count


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,          # [N] activated
    camera,
    bg: torch.Tensor,
    *,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    active_sh_degree=None,
    colors: Optional[torch.Tensor] = None,
    features: Optional[torch.Tensor] = None,
    vfeatures: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    cfg: RasterConfig = RasterConfig(),
    weights_grad: bool = True,
    need_weights: bool = True,
) -> RenderBuffers:
    """Differentiable surfel rasterization of one camera.

    ``mean2d_offset`` ([N, 2] zeros) lets callers take gradients with
    respect to screen-space positions (densification statistics).
    """
    width, height = camera.width, camera.height
    tile = cfg.tile
    grid_x = -(-width // tile)
    grid_y = -(-height // tile)

    prep = preprocess(
        means3d, scales, quats, camera.world_view, camera.full_proj,
        camera.camera_center, width=width, height=height,
        tanfovx=camera.tanfovx, tanfovy=camera.tanfovy,
        focal_x=camera.focal_x, focal_y=camera.focal_y,
        shs=shs, sh_degree=sh_degree, active_sh_degree=active_sh_degree,
        colors=colors, scale_modifier=scale_modifier, cfg=cfg)
    if mask is not None:
        valid = prep.valid & mask
        prep = prep._replace(
            valid=valid,
            radius=torch.where(valid, prep.radius, 0),
            tiles_touched=torch.where(valid, prep.tiles_touched, 0))
    if mean2d_offset is not None:
        prep = prep._replace(mean2d=prep.mean2d + mean2d_offset)

    if cfg.binner != "counting" or cfg.strip <= 0:
        raise ValueError("the reference rasterizes with the counting binner "
                         "and the image-layout blend (strip > 0) only")
    padded = bin_instances_counting(prep, width=width, height=height,
                                    cfg=cfg)

    slab_g, ca, cv = _pack_slab(prep, opacity, features, vfeatures, cfg)
    kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=grid_y, tile=tile,
              chunk=cfg.chunk)
    tile_start, tile_count = _clamp_runs(padded, cfg.max_instances,
                                         cfg.chunk)
    # one extra all-zero row: padding slots (gid -1) gather it and their
    # gradients scatter back into it
    slab_ext = torch.cat([slab_g, slab_g.new_zeros(1, slab_g.shape[1])])
    img_p, weights = _BlendGather.apply(slab_ext, padded.gaussian_id,
                                        tile_start, tile_count, kw,
                                        weights_grad, need_weights)
    img = img_p[:, :height, :width]

    s = 0 if features is None else features.shape[1]
    color_raw = img[0:3]
    normal = img[3:6]
    adepth, c1img, c2img = img[6], img[7], img[8]
    feat = img[9:9 + s]
    vfeat = img[ca:ca + cv]
    logT = img[ca + cv]
    n_contrib = img[ca + cv + 1].detach().to(torch.int32)

    dev = means3d.device
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    D = adepth + uu * c1img + vv * c2img
    T = torch.clamp(torch.exp(logT), max=1.0 - 1e-6)
    color = color_raw + T[None] * bg[:, None, None]
    depth = common.finalize_depth(D, T, cfg.normalize_depth)[None]

    return RenderBuffers(
        color=color, normal=normal, depth=depth, opacity=(1.0 - T)[None],
        feature=feat, vfeature=vfeat, final_t=T, n_contrib=n_contrib,
        weights=weights[:, None], radii=prep.radius,
        overflow=padded.overflow)
