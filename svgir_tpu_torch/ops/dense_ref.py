"""Dense O(N * H * W) reference renderer: the correctness oracle for small
scenes.

Counterpart of ``svgir_tpu.ops.dense_ref.render_dense``: every Gaussian is
evaluated at every pixel in exact global depth order (stable, invalid
Gaussians last) with the blend math of the tiled path, including the
tile-rect containment test, so the tiled paths agree with it wherever no
tile exits early.  It uses no binner, no chunks and no kernel, and is
differentiable by autograd.

The reference walks the Gaussians one at a time (``lax.scan``); this walks
them in depth-ordered batches of ``_BATCH``, forming the transmittance
before each Gaussian as the running logT plus an exclusive prefix sum over
the batch.  The results are the same up to float32 summation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.ops import common
from svgir_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN, LOG_T_EPS
from svgir_tpu_torch.ops.preprocess import Preprocessed
from svgir_tpu_torch.ops.rasterizer import RenderBuffers

__all__ = ["RenderBuffers", "render_dense"]

# Gaussians per depth-ordered batch; it sets only the float32 summation
# order of the running logT and the channel sums
_BATCH = 64


def render_dense(
    prep: Preprocessed,
    opacity: torch.Tensor,              # [N] activated opacity
    features: Optional[torch.Tensor],
    vfeatures: Optional[torch.Tensor],
    bg: torch.Tensor,
    *,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
) -> RenderBuffers:
    n = prep.mean2d.shape[0]
    dev = prep.mean2d.device
    s = 0 if features is None else features.shape[1]
    cvs = 0 if vfeatures is None else vfeatures.shape[1] // 4

    key = torch.where(prep.valid, prep.depth.detach(),
                      torch.full_like(prep.depth, float("inf")))
    order = torch.sort(key, stable=True)[1]

    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    tile_x = (uu / cfg.tile).to(torch.int32)
    tile_y = (vv / cfg.tile).to(torch.int32)

    z = prep.mean2d.new_zeros
    logT = z(height, width)
    acc_c, acc_n, acc_d = z(3, height, width), z(3, height, width), \
        z(height, width)
    acc_f, acc_vf = z(s, height, width), z(cvs, height, width)
    n_contrib = torch.zeros(height, width, dtype=torch.int32, device=dev)
    w_sums = []
    for b0 in range(0, n, _BATCH):
        g = order[b0:b0 + _BATCH]

        def col(x):                      # [B] -> [B, 1, 1]
            return x[g][:, None, None]

        dx = col(prep.mean2d[:, 0]) - uu                       # [B, H, W]
        dy = col(prep.mean2d[:, 1]) - vv
        power = -0.5 * (col(prep.conic[:, 0]) * dx * dx
                        + col(prep.conic[:, 2]) * dy * dy) \
            - col(prep.conic[:, 1]) * dx * dy
        alpha = torch.clamp(col(opacity) * torch.exp(power), max=ALPHA_MAX)
        in_rect = ((tile_x >= col(prep.rect_min[:, 0]))
                   & (tile_x < col(prep.rect_max[:, 0]))
                   & (tile_y >= col(prep.rect_min[:, 1]))
                   & (tile_y < col(prep.rect_max[:, 1])))
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect \
            & col(prep.valid)
        loga = torch.where(ok, torch.log1p(-alpha), 0.0)
        logT_excl = logT + (torch.cumsum(loga, 0) - loga)
        contrib = ok & (logT_excl >= LOG_T_EPS)
        w = torch.where(contrib, alpha * torch.exp(logT_excl), 0.0)

        du0 = dx * col(prep.jinv[:, 0]) + dy * col(prep.jinv[:, 1])
        du1 = dx * col(prep.jinv[:, 2]) + dy * col(prep.jinv[:, 3])
        if cfg.surface and cfg.per_pixel_depth:
            depth_px = col(prep.depth) - (du0 * col(prep.jinv[:, 6])
                                          + du1 * col(prep.jinv[:, 9]))
            u = torch.clamp(du0 / (0.5 * col(prep.lam[:, 0]) + 0.1) * 0.5
                            + 0.5, 0.001, 0.999)
            v = torch.clamp(du1 / (0.5 * col(prep.lam[:, 1]) + 0.1) * 0.5
                            + 0.5, 0.001, 0.999)
            wv = ((1 - u) * (1 - v), u * (1 - v), (1 - u) * v, u * v)
        else:
            depth_px = col(prep.depth).expand_as(dx)
            wv = (torch.zeros_like(dx),) * 4

        acc_c = acc_c + torch.einsum("bhw,bc->chw", w, prep.rgb[g])
        if cfg.surface:
            acc_n = acc_n + torch.einsum("bhw,bc->chw", w,
                                         prep.normal_view[g])
        acc_d = acc_d + (w * depth_px).sum(0)
        if s:
            acc_f = acc_f + torch.einsum("bhw,bc->chw", w, features[g])
        if cvs:
            vf = vfeatures[g].reshape(len(g), cvs, 4)
            for k in range(4):
                acc_vf = acc_vf + torch.einsum("bhw,bc->chw", w * wv[k],
                                               vf[:, :, k])
        logT = logT + loga.sum(0)
        n_contrib = n_contrib + contrib.sum(0, dtype=torch.int32)
        w_sums.append(w.sum((1, 2)))

    T = torch.clamp(torch.exp(logT), max=1.0 - 1e-6)
    color = acc_c + T[None] * bg[:, None, None]
    depth = common.finalize_depth(acc_d, T, cfg.normalize_depth)[None]
    # per-Gaussian weight sums back in input order
    weights = prep.mean2d.new_zeros(n).index_copy(
        0, order, torch.cat(w_sums) if w_sums else prep.mean2d.new_zeros(0))
    return RenderBuffers(
        color=color, normal=acc_n, depth=depth, opacity=(1.0 - T)[None],
        feature=acc_f, vfeature=acc_vf, final_t=T, n_contrib=n_contrib,
        weights=weights[:, None], radii=prep.radius,
        overflow=torch.zeros((), dtype=torch.bool, device=dev))
