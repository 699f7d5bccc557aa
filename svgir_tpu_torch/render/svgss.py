"""Stage-2 ("render_relight") forward and loss: the deferred-PBR mode.

Mirrors ``svgir_tpu.render.svgss`` (reference
``gaussian_renderer/svgss.py``): shade each surfel's 4 vertices over the
baked incident radiance and the learnable env, before rasterization (train:
``shade_train``, which gives pbr and the diffuse light only; eval:
``rendering_equation4``); blend the features [visibility (1), local
lights (3)] (train, S = 4) and the vertex features [pbr (12), base color
(12), view normal (12), roughness (4), diffuse light (12)] (VS = 52; eval
blends [lights, local lights, visibility] (S = 7) and adds direct and
indirect, VS = 64); then the stage-2 loss (svgss.py:265-403).

The env is looked up once per call at the bake's incident directions
(kernel B7 through ``models/lights``); the shading and the consistency
loss share that lookup.  The eval render looks the env up again at every
pixel's world direction for the env composites.  The relighting
evaluation replaces the learnable env with a fixed light (``env_fn`` and,
for the bake's precomputed grid coordinates, ``env_qxy_fn``) and rescales
the base colour per channel (``base_color_scale``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.models import radiance as RAD
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.ops.shading import rendering_equation4, shade_train
from svgir_tpu_torch.utils import losses as L
from svgir_tpu_torch.utils import profiling
from svgir_tpu_torch.utils.graphics import rgb_to_srgb
from svgir_tpu_torch.utils.image import depth2normal
from svgir_tpu_torch.utils.transforms import normalize


@profiling.span("svgir.render")
def render_view_svgss(camera, params, bake: Dict, env_params,
                      bg: torch.Tensor, *, is_training: bool = True,
                      alive: Optional[torch.Tensor] = None,
                      mean2d_offset: Optional[torch.Tensor] = None,
                      sh_degree: int = 3,
                      base_color_scale: Optional[torch.Tensor] = None,
                      env_fn=None, env_qxy_fn_override=None,
                      cfg: RasterConfig = RasterConfig()) -> Dict[str, Any]:
    """svgss.py:15-262.  ``bake``: the radiance bake's buffers
    (``incident_dirs``, ``incident_areas``, ``incident_qxy``,
    ``visibility``, ``hit_idx``, ``uv``).  The env is the learnable map
    ``env_params`` unless ``env_fn(dirs)`` replaces it; then the bake's
    ``incident_qxy`` go to ``env_qxy_fn_override(qxy)`` where one is given,
    else the directions to ``env_fn``.  ``base_color_scale`` [3] rescales
    the base colour per channel; ``mean2d_offset`` ([N, 2] zeros) lets
    callers take gradients with respect to screen-space positions."""
    n = params["xyz"].shape[0]
    xyz = params["xyz"]
    opacity = G.get_opacity(params)[:, 0]
    if alive is not None:
        opacity = torch.where(alive, opacity, torch.zeros_like(opacity))

    base_color = G.get_base_color(params, base_color_scale)      # [N, 12]
    roughness = G.get_roughness(params)                          # [N, 4]
    shading_normal = G.get_shading_normal(params)                # [N, 4, 3]
    if not is_training:
        shading_normal = shading_normal.detach()
    radiances = G.get_radiances(params)                          # [N, S, 3]
    viewdirs = normalize(camera.camera_center[None] - xyz)

    env_qxy_fn = None
    if env_fn is None:
        def env_fn(dirs):
            return LT.direct_light(env_params, dirs)

        def env_qxy_fn(q):
            return LT.direct_light_qxy(env_params, q[..., 0], q[..., 1])
    elif env_qxy_fn_override is not None:
        env_qxy_fn = env_qxy_fn_override

    with profiling.span("svgir.shading"):
        # one env evaluation, shared by the shading and the consistency
        # loss
        qxy = bake.get("incident_qxy")
        if qxy is not None and env_qxy_fn is not None:
            env_radiance = env_qxy_fn(qxy)
        else:
            env_radiance = env_fn(bake["incident_dirs"])

        mark = profiling.layer("svgir.shading")
        if is_training:
            # the step reads pbr and the diffuse light only
            pbr, diffuse_light = profiling.layer_out(mark, shade_train(
                base_color, roughness, shading_normal, viewdirs, radiances,
                env_radiance, bake["visibility"], bake["incident_dirs"],
                bake["incident_areas"]))
        else:
            pbr, extra = profiling.layer_out(mark, rendering_equation4(
                base_color, roughness, shading_normal, viewdirs, radiances,
                env_fn, bake["visibility"], bake["incident_dirs"],
                bake["incident_areas"], env_radiance=env_radiance))
            diffuse_light = extra["diffuse_light"]

    if is_training:
        features = torch.cat([bake["visibility"].mean(-2),
                              radiances.mean(-2)], dim=-1)       # S = 4
    else:
        features = torch.cat([
            extra["incident_lights"].mean(-2),
            extra["local_incident_lights"].mean(-2),
            extra["incident_visibility"].mean(-2)], dim=-1)     # S = 7

    # view-space shading normals, channel-major [N, 12] (svgss.py:158-159)
    nrm_view = shading_normal @ camera.world_view[:3, :3].T      # [N, 4, 3]
    nrm_view = nrm_view.transpose(1, 2).reshape(n, -1)
    if is_training:
        vfeatures = torch.cat(
            [pbr, base_color, nrm_view, roughness, diffuse_light],
            dim=-1)                                              # VS = 52
    else:
        vfeatures = torch.cat(
            [pbr, base_color, nrm_view, roughness, extra["direct"],
             extra["indirect"]], dim=-1)                         # VS = 64

    # the per-Gaussian weight sums only feed densification statistics,
    # and stage 2 does not densify: the blend skips them
    bufs = rasterize(xyz, G.get_scaling(params), G.get_rotation(params),
                     opacity, camera, bg, shs=G.get_shs(params),
                     sh_degree=sh_degree, features=features,
                     vfeatures=vfeatures, mean2d_offset=mean2d_offset,
                     cfg=cfg, mask=alive, weights_grad=False,
                     need_weights=False)

    opac = bufs.opacity
    feat = bufs.feature / torch.clamp(opac, min=1e-5)
    vfeat = bufs.vfeature / torch.clamp(opac, min=1e-5)
    bgc = bg[:, None, None]

    def opacity_filter(r):
        return r * opac + (1 - opac) * bgc

    results: Dict[str, Any] = {
        "render": bufs.color,
        "depth": bufs.depth,
        "opacity": opac,
        "weights": bufs.weights,
        "radii": bufs.radii,
        "visibility_filter": bufs.radii > 0,
        "n_contrib": bufs.n_contrib,
        "overflow": bufs.overflow,
        "diffuse_light": diffuse_light,
        "_env_radiance": env_radiance,
    }

    if is_training:
        r_vis, r_local = feat[0:1], feat[1:4]
        results["local_lights"] = opacity_filter(rgb_to_srgb(r_local))
        results["visibility"] = opacity_filter(r_vis)
        r_pbr, r_base, r_nrm, r_rough, r_diff = (
            vfeat[0:3], vfeat[3:6], vfeat[6:9], vfeat[9:10], vfeat[10:13])
        results["base_color"] = opacity_filter(rgb_to_srgb(r_base))
        results["diffuse"] = opacity_filter(rgb_to_srgb(r_diff))
        results["roughness"] = opacity_filter(r_rough)
    else:
        r_light, r_local, r_vis = feat[0:3], feat[3:6], feat[6:7]
        results["lights"] = opacity_filter(rgb_to_srgb(r_light))
        results["local_lights"] = opacity_filter(rgb_to_srgb(r_local))
        results["visibility"] = opacity_filter(r_vis)
        r_pbr, r_base, r_nrm, r_rough, r_direct, r_indirect = (
            vfeat[0:3], vfeat[3:6], vfeat[6:9], vfeat[9:10], vfeat[10:13],
            vfeat[13:16])
        results["base_color"] = opacity_filter(rgb_to_srgb(r_base))
        results["direct"] = rgb_to_srgb(r_direct)
        results["indirect"] = rgb_to_srgb(r_indirect)
        results["roughness"] = opacity_filter(r_rough)

    results["pbr"] = rgb_to_srgb(r_pbr * opac + (1 - opac) * bgc)
    results["normal"] = r_nrm            # view space: the losses see this
    image_mask = camera.image_mask if camera.image_mask is not None else \
        torch.ones_like(opac)
    results["pseudo_normal"] = depth2normal(bufs.depth, image_mask, camera)
    results["env"] = LT.env_activated(env_params) if env_params else None

    if not is_training:
        env_img = env_fn(camera.world_directions().permute(1, 2, 0))
        env_img = env_img.permute(2, 0, 1)                       # [3, H, W]
        results["render_env"] = bufs.color + (1 - opac) * rgb_to_srgb(env_img)
        results["pbr_env"] = rgb_to_srgb(r_pbr * opac + (1 - opac) * env_img)
        results["env_only"] = rgb_to_srgb(env_img)

    return results


@profiling.span("svgir.losses")
def calculate_loss_svgss(camera, params, bake, results,
                         opt: OptimizationConfig, env_params, iteration, *,
                         alive=None) -> tuple[torch.Tensor, Dict]:
    """svgss.py:265-403, with the reference's weights and gating.
    (``lambda_local_lights_smooth`` is consumed by no loss in the
    reference, so it adds no term here either.)"""
    rendered = results["render"]
    depth = results["depth"]
    normal = results["normal"]
    pbr = results["pbr"]
    opac = results["opacity"]
    gt = camera.image
    image_mask = camera.image_mask if camera.image_mask is not None else \
        torch.ones_like(depth)

    tb = {}
    l1 = L.l1_loss(rendered, gt)
    ssim_val, ssim_pbr = L.ssim_pair(rendered, pbr, gt)
    tb["l1"], tb["ssim"], tb["psnr"] = l1, ssim_val, L.psnr(rendered, gt)
    loss = (1 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1 - ssim_val)

    l1_pbr = L.l1_loss(pbr, gt)
    tb["l1_pbr"], tb["psnr_pbr"] = l1_pbr, L.psnr(pbr, gt)
    loss = loss + opt.lambda_pbr * (
        (1 - opt.lambda_dssim) * l1_pbr + opt.lambda_dssim * (1 - ssim_pbr))

    d2n = depth2normal(depth, image_mask, camera)
    loss_surface = L.cos_loss(normal, d2n)
    loss = loss + 0.02 * loss_surface
    tb["loss_surface"] = loss_surface

    # normal-offset regularizer (svgss.py:316)
    loss = loss + 0.1 * (params["normal"] ** 2).mean()

    # radiance consistency (svgss.py:319), on the render's env lookup
    loss_rad = RAD.radiance_consistency_loss(
        params, bake, camera.camera_center,
        lambda d: LT.direct_light(env_params, d), alive=alive,
        env_radiance=results.get("_env_radiance"))
    loss = loss + opt.lambda_radiance * loss_rad
    tb["loss_radiance"] = loss_rad

    if opt.lambda_mask_entropy > 0:
        lme = L.mask_entropy_loss(opac, image_mask)
        loss = loss + opt.lambda_mask_entropy * lme
        tb["loss_mask_entropy"] = lme

    if opt.lambda_base_color_smooth > 0:
        lb = L.first_order_edge_aware_loss(
            results["base_color"] * image_mask, gt * image_mask)
        loss = loss + opt.lambda_base_color_smooth * lb
        tb["loss_base_color_smooth"] = lb

    if opt.lambda_roughness_smooth > 0:
        lr = L.first_order_edge_aware_loss(
            results["roughness"] * image_mask, gt * image_mask)
        loss = loss + opt.lambda_roughness_smooth * lr
        tb["loss_roughness_smooth"] = lr

    if opt.lambda_light_smooth > 0:
        lsm = L.first_order_edge_aware_loss(
            results["diffuse"] * image_mask, normal)
        loss = loss + opt.lambda_light_smooth * lsm
        tb["loss_light_smooth"] = lsm

    if opt.lambda_env_smooth > 0 and results.get("env") is not None:
        le = L.tv_loss(results["env"].permute(2, 0, 1))
        loss = loss + opt.lambda_env_smooth * le
        tb["loss_env_smooth"] = le

    if opt.lambda_normal_smooth > 0:    # svgss.py:394-399 (stage 2 only)
        lns = L.second_order_edge_aware_loss(normal * image_mask, gt)
        loss = loss + opt.lambda_normal_smooth * lns
        tb["loss_normal_smooth"] = lns

    if opt.lambda_light > 0:
        dl = results["diffuse_light"]
        ll2 = (dl - dl.mean(-1, keepdim=True)).abs().mean()
        loss = loss + opt.lambda_light * ll2
        tb["loss_light"] = ll2

    tb["loss"] = loss
    return loss, tb


def render_svgss(camera, params, bg, *, bake=None, env_params=None,
                 opt: OptimizationConfig = None, iteration=0,
                 is_training=False, alive=None, mean2d_offset=None,
                 sh_degree=3, base_color_scale=None, env_fn=None,
                 env_qxy_fn=None, cfg: RasterConfig = RasterConfig(),
                 **_) -> Dict[str, Any]:
    """svgss.py:406-424: render, loss, then rotate the normals to world
    space after the loss (the losses see view space).  ``mean2d_offset``,
    ``env_fn``, ``env_qxy_fn`` and ``base_color_scale`` as
    ``render_view_svgss``'s; other keywords (a stage-1 render's ``mono``)
    are ignored."""
    results = render_view_svgss(
        camera, params, bake, env_params, bg, is_training=is_training,
        alive=alive, mean2d_offset=mean2d_offset, sh_degree=sh_degree,
        base_color_scale=base_color_scale, env_fn=env_fn,
        env_qxy_fn_override=env_qxy_fn, cfg=cfg)
    if is_training:
        loss, tb = calculate_loss_svgss(
            camera, params, bake, results, opt, env_params, iteration,
            alive=alive)
        results["loss"] = loss
        results["tb_dict"] = tb

    c2w_rot = camera.world_view[:3, :3].T
    for key in ("normal", "pseudo_normal"):
        results[key] = torch.einsum("ij,jhw->ihw", c2w_rot, results[key])
    return results
