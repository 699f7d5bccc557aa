"""Stage-1 ("render" mode) forward and loss.

Mirrors ``svgir_tpu.render.stage1`` (reference
``gaussian_renderer/render.py``): rasterize color / normal / depth plus the
blended features [world geo normal, depth, depth^2], then the stage-1 loss
recipe (render.py:137-232).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.utils import losses as L
from svgir_tpu_torch.utils import profiling
from svgir_tpu_torch.utils.image import depth2normal


def _maxpool9(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(9, stride=1, padding=4) on [1, H, W]."""
    return F.max_pool2d(x[None], 9, stride=1, padding=4)[0]


@profiling.span("svgir.render")
def render_view_stage1(camera, params, bg: torch.Tensor, *,
                       sh_degree: int = 3, active_sh_degree=None,
                       alive: Optional[torch.Tensor] = None,
                       mean2d_offset: Optional[torch.Tensor] = None,
                       need_weights: bool = True,
                       cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """gaussian_renderer/render.py:17-135 equivalent."""
    xyz = params["xyz"]
    opacity = G.get_opacity(params)[:, 0]
    if alive is not None:
        opacity = torch.where(alive, opacity, torch.zeros_like(opacity))
    scaling = G.get_scaling(params)
    rotation = G.get_rotation(params)
    geo_normal = G.get_geo_normal(params)

    hom = torch.cat([xyz, xyz.new_ones(xyz.shape[0], 1)], -1)
    depths = (hom @ camera.world_view.T)[:, 2:3]
    features = torch.cat([geo_normal, depths, depths * depths], -1)

    # weights_grad=False: the weights only feed densification statistics
    bufs = rasterize(
        xyz, scaling, rotation, opacity, camera, bg,
        shs=G.get_shs(params), sh_degree=sh_degree,
        active_sh_degree=active_sh_degree, features=features,
        mean2d_offset=mean2d_offset, cfg=cfg, mask=alive, weights_grad=False,
        need_weights=need_weights)

    opac = bufs.opacity
    mask_contrib = (bufs.n_contrib > 0).to(opac.dtype)[None]
    feat = bufs.feature / torch.clamp(opac, min=1e-5) * mask_contrib
    feat_normal, feat_depth2 = feat[0:3], feat[4:5]
    depth_var = feat_depth2 - bufs.depth ** 2

    image_mask = camera.image_mask if camera.image_mask is not None else \
        torch.ones(1, camera.height, camera.width, device=xyz.device)
    pseudo_normal = depth2normal(bufs.depth, image_mask, camera)

    return {
        "render": bufs.color,
        "opacity": opac,
        "depth": bufs.depth,
        "depth_var": depth_var,
        "normal": bufs.normal,
        "feat_normal_world": feat_normal,
        "pseudo_normal": pseudo_normal,
        "weights": bufs.weights,
        "radii": bufs.radii,
        "visibility_filter": bufs.radii > 0,
        "n_contrib": bufs.n_contrib,
        "overflow": bufs.overflow,
        "buffers": bufs,
    }


@profiling.span("svgir.losses")
def calculate_loss_stage1(camera, params, results, opt: OptimizationConfig,
                          iteration, *, mono=None):
    """render.py:137-232: the terms of the shipped recipes plus the
    lambda-gated extras, with the reference's gating."""
    rendered = results["render"]
    opacity = results["opacity"]
    depth = results["depth"]
    normal = results["normal"]
    gt = camera.image
    image_mask = camera.image_mask if camera.image_mask is not None else \
        torch.ones_like(depth)

    tb = {}
    l1 = L.l1_loss(rendered, gt)
    ssim_val = L.ssim(rendered, gt)
    tb["l1"], tb["ssim"] = l1, ssim_val
    tb["psnr"] = L.psnr(rendered, gt)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_val)

    d2n = depth2normal(depth, image_mask, camera)
    loss_mask = (opacity * (1 - _maxpool9(image_mask))).mean()
    loss_surface = L.cos_loss(normal, d2n)

    t = min(max(float(iteration) / opt.iterations, 0.0), 1.0)
    loss = loss + 0.01 * loss_mask
    loss = loss + (0.01 + 0.01 * t) * loss_surface
    tb["loss_mask"], tb["loss_surface"] = loss_mask, loss_surface

    if mono is not None:
        mono_m = mono * image_mask
        loss_mono = L.cos_loss(normal, mono_m[:3], weight=image_mask)
        loss = loss + (0.04 - t * 0.02) * loss_mono
        tb["loss_mono"] = loss_mono

    if opt.lambda_mask_entropy > 0:
        lme = L.mask_entropy_loss(opacity, image_mask)
        loss = loss + opt.lambda_mask_entropy * lme
        tb["loss_mask_entropy"] = lme

    if opt.lambda_depth_smooth > 0:
        lds = L.first_order_edge_aware_loss(depth, gt)
        loss = loss + opt.lambda_depth_smooth * lds
        tb["loss_depth_smooth"] = lds

    if opt.lambda_scaling > 0:
        scaling = G.get_scaling(params)
        sc = (scaling - scaling.mean(-1, keepdim=True)).abs().sum(-1).mean()
        lam = opt.lambda_scaling * (1 - 0.99 * min(
            1.0, 4 * float(iteration) / opt.iterations))
        loss = loss + lam * sc
        tb["loss_scaling"] = sc

    tb["loss"] = loss
    return loss, tb


def render_stage1(camera, params, bg, *, opt: OptimizationConfig,
                  iteration=0, is_training=False, alive=None,
                  mean2d_offset=None, sh_degree=3, mono=None,
                  need_weights=True,
                  cfg: RasterConfig = RasterConfig(), **_) -> Dict[str, Any]:
    # SH-degree ramp (reference train.py:115-116: +1 per 1000 iterations)
    active = min(float(sh_degree), float(int(float(iteration) // 1000))) \
        if is_training else None
    results = render_view_stage1(camera, params, bg, sh_degree=sh_degree,
                                 active_sh_degree=active, alive=alive,
                                 mean2d_offset=mean2d_offset,
                                 need_weights=need_weights, cfg=cfg)
    if is_training:
        loss, tb = calculate_loss_stage1(camera, params, results, opt,
                                         iteration, mono=mono)
        results["loss"] = loss
        results["tb_dict"] = tb
    return results
