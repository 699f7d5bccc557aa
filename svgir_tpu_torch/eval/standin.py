"""Stand-in end-to-end harness: the whole pipeline against procedural
ground truth.

Mirrors ``svgir_tpu.eval.standin``.  No dataset ships, so the TensoIR
metric flow (eval_relighting_tensoIR.py:35-409) runs against a known
spatially varying PBR surfel model, which renders multi-view ground truth
under an env L1 and relit ground truth under a second env L2 through the
same forward model.  The pipeline must recover them from scratch:

  stage 1  fresh surfels with densification  -> NVS PSNR against GT
  stage 2  PBR decomposition, frozen geometry -> pbr PSNR against GT
  relight  re-bake under L2 and the median albedo calibration
           (the eval_relighting flow)         -> relight and albedo PSNR

Every random draw of the reference (``jax.random``) comes from a
``torch.Generator`` seeded with ``seed``, or from an argument that
injects it, so that tests can pass JAX's draws in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.eval.relighting import (calibrate_albedo_scale,
                                             rebake_radiance_for_light)
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.render.svgss import render_svgss
from svgir_tpu_torch.utils.transforms import normalize


def _draw(draw, shape, generator, kind, device):
    """The injected ``draw`` as a float32 tensor on ``device``, else one
    made on the CPU from ``generator`` (``kind`` "normal" or "uniform")."""
    if draw is None:
        fn = torch.randn if kind == "normal" else torch.rand
        draw = fn(shape, generator=generator)
    if not isinstance(draw, torch.Tensor):
        draw = torch.tensor(np.array(draw, np.float32))
    return draw.to(device=device, dtype=torch.float32).reshape(shape)


def make_gt_model(n: int = 400, radius: float = 1.0, *,
                  generator: Optional[torch.Generator] = None,
                  dirs_draw=None, device="cuda") -> Dict:
    """A known PBR surfel model: a sphere shell of ``n`` surfels facing
    out, a spatially varying albedo (two hemispheres of distinct base
    colours and a positional tint), roughness 0.5, zero normal offsets.
    ``dirs_draw`` [n, 3] are the standard-normal draws of the directions."""
    dirs = normalize(_draw(dirs_draw, (n, 3), generator, "normal", device))
    pts = dirs * radius
    state = G.init_from_points(pts, torch.full((n, 3), 0.5, device=device),
                               normals=dirs, capacity=n,
                               rotation_init="normal", device=device)
    state = G.upgrade_to_pbr(state)
    params = dict(state["params"])

    # spatially varying albedo in [0.1, 0.77]: hemisphere split + tint
    base = torch.where(pts[:, 0:1] > 0,
                       torch.tensor([[0.7, 0.25, 0.2]], device=device),
                       torch.tensor([[0.2, 0.35, 0.7]], device=device))
    tint = 0.15 * torch.stack([torch.sin(3 * pts[:, 1]),
                               torch.cos(2 * pts[:, 2]),
                               torch.sin(2 * pts[:, 0])], dim=-1)
    albedo = torch.clamp(base + tint, 0.1, 0.77)
    # the inverse of sigmoid(x) * 0.77 + 0.03, on each of the 4 vertices
    raw = torch.log((albedo - 0.03) / (0.77 - (albedo - 0.03)))
    params["base_color"] = torch.repeat_interleave(raw, 4, dim=-1)
    # roughness 0.5: the inverse of sigmoid(x) * 0.9 + 0.09
    r_raw = math.log((0.5 - 0.09) / (0.9 - (0.5 - 0.09)))
    params["roughness"] = torch.full((n, 4), r_raw, device=device)
    params["normal"] = torch.zeros(n, 12, device=device)
    return {**state, "params": params}


def make_env(h: int = 16, bright: float = 1.5, *,
             generator: Optional[torch.Generator] = None, base_draw=None,
             az_draw=None, device="cuda") -> Dict:
    """A fixed synthetic HDR light (an EnvLight): a smooth low-frequency
    map with a dominant lobe at a random azimuth.  ``base_draw`` [4, 8, 3]
    and ``az_draw`` (one) are its uniform draws."""
    base = 0.3 + 0.4 * _draw(base_draw, (4, 8, 3), generator, "uniform",
                             device)
    az = 2 * math.pi * float(_draw(az_draw, (), generator, "uniform",
                                   device))
    w = 2 * h
    img = LT.resize_linear(base, h, w)
    th = torch.linspace(0, math.pi, h, device=device)[:, None]
    ph = torch.linspace(-math.pi, math.pi, w, device=device)[None, :]
    lobe = torch.exp(-((ph - (az - math.pi)) ** 2 + (th - 1.2) ** 2) / 0.4)
    img = img + bright * lobe[..., None]
    return LT.env_light_init(img.cpu().numpy(), device=device)


def ring_cameras(k: int, res: int, dist: float = 3.0, heights=(0.4, -0.3),
                 device="cuda") -> List:
    cams = []
    for i in range(k):
        a = 2 * math.pi * i / k
        hgt = heights[i % len(heights)]
        cams.append(look_at_camera(
            eye=[dist * math.sin(a), hgt, -dist * math.cos(a)],
            target=[0, 0, 0], up=[0, -1, 0], fovx=math.pi / 3,
            fovy=math.pi / 3, width=res, height=res, device=device))
    return cams


def _eval_params(state, env_state, sample_num, azimuth):
    """The model's params with its radiances re-baked under ``env_state``
    (the spirals turned by ``azimuth`` [n_alive, 1]), and the bake."""
    bake, radiances = rebake_radiance_for_light(
        state["params"], state["alive"], env_state, sample_num=sample_num,
        azimuth=azimuth)
    p = {**state["params"], "radiances": radiances,
         "radiance_ratio": torch.ones((), device=radiances.device)}
    return p, {k: v for k, v in bake.items() if k != "exhausted_frac"}


def _env_fns(env_state):
    def env_fn(dirs):
        return LT.env_light_direct(env_state, dirs)

    env_qxy_fn = None        # the precomputed coordinates need no transform
    if env_state.get("transform") is None:
        def env_qxy_fn(q):
            return LT.env_light_direct_qxy(env_state, q[..., 0], q[..., 1])
    return env_fn, env_qxy_fn


@torch.no_grad()
def render_gt_views(state, env_state, cams, *, sample_num: int,
                    cfg: RasterConfig, azimuth=None) -> List:
    """The GT model rendered in eval mode with its radiance re-baked
    under ``env_state``: each camera with its pbr image (clipped to
    [0, 1]) and its mask (opacity > 0.3)."""
    p, bake = _eval_params(state, env_state, sample_num, azimuth)
    env_fn, env_qxy_fn = _env_fns(env_state)
    bg = torch.zeros(3, device=p["xyz"].device)
    out = []
    for cam in cams:
        res = render_svgss(cam, p, bg, bake=bake, env_params=None,
                           env_fn=env_fn, env_qxy_fn=env_qxy_fn,
                           opt=OptimizationConfig(), is_training=False,
                           alive=state["alive"], cfg=cfg)
        mask = (res["opacity"][0] > 0.3).to(torch.float32)
        out.append(dataclasses.replace(
            cam, image=torch.clamp(res["pbr"], 0, 1), image_mask=mask[None]))
    return out


def _psnr(a, b) -> float:
    mse = torch.mean((torch.clamp(a, 0, 1) - torch.clamp(b, 0, 1)) ** 2)
    return float(-10 * torch.log10(mse))


def run_standin_parity(*, n_gt=400, n_views=12, res=48, sample_num=8,
                       stage1_iters=300, stage2_iters=150,
                       init_points=150, capacity=1024,
                       cfg: RasterConfig = RasterConfig(max_instances=1 << 14),
                       seed=0, verbose=True, device="cuda") -> Dict[str, float]:
    """The whole pipeline against procedural GT.  Returns the metrics:
    n_alive_after_stage1, stage1_nvs_psnr, stage2_pbr_psnr, relight_psnr
    and albedo_psnr."""
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train.trainer import train_stage1, train_stage2

    gen = torch.Generator().manual_seed(seed)
    gt_state = make_gt_model(n=n_gt, generator=gen, device=device)
    env1 = make_env(generator=gen, device=device)
    env2 = make_env(bright=2.5, generator=gen, device=device)
    # one draw of the GT bake's spirals serves each GT render, as the
    # reference's one key does
    az_gt = torch.rand(n_gt, 1, generator=gen).to(device)

    cams_all = ring_cameras(n_views + 4, res, device=device)
    gt1 = render_gt_views(gt_state, env1, cams_all, sample_num=sample_num,
                          cfg=cfg, azimuth=az_gt)
    train_cams, test_cams = gt1[:n_views], gt1[n_views:]
    gt2_test = render_gt_views(gt_state, env2, cams_all[n_views:],
                               sample_num=sample_num, cfg=cfg, azimuth=az_gt)

    out: Dict[str, float] = {}

    # ---- stage 1: a fresh model with densification ----------------------
    init_pts = normalize(torch.randn(init_points, 3, generator=gen)) \
        * (1.0 + 0.1 * torch.randn(init_points, 1, generator=gen))
    state = G.init_from_points(init_pts.to(device),
                               torch.full((init_points, 3), 0.5),
                               capacity=capacity, device=device)
    opt1 = OptimizationConfig(
        iterations=stage1_iters, densify_from_iter=50,
        densify_until_iter=int(stage1_iters * 0.8),
        densification_interval=50, opacity_reset_interval=10 ** 9,
        position_lr_max_steps=stage1_iters, lambda_mask_entropy=0.1)
    state, _, _ = train_stage1(
        state, train_cams, opt1, bg=(0, 0, 0), raster_cfg=cfg,
        spatial_lr_scale=1.0, iterations=stage1_iters, log_every=100,
        seed=seed, device=device)
    out["n_alive_after_stage1"] = float(state["alive"].sum())

    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        vals = [_psnr(render_view_stage1(cam, state["params"], bg,
                                         alive=state["alive"],
                                         cfg=cfg)["render"], cam.image)
                for cam in test_cams]
    out["stage1_nvs_psnr"] = float(np.mean(vals))
    if verbose:
        print(f"stage1: test NVS psnr {out['stage1_nvs_psnr']:.2f} "
              f"({int(out['n_alive_after_stage1'])} alive)", flush=True)

    # ---- stage 2: PBR decomposition (frozen geometry, run_tensoir.sh) ----
    state = G.upgrade_to_pbr(state)
    opt2 = OptimizationConfig(
        iterations=stage1_iters + stage2_iters,
        position_lr_init=0.0, position_lr_final=0.0, scaling_lr=0.0,
        rotation_lr=0.0, sh_lr=0.00025, opacity_lr=0.005, normal_lr=0.001,
        lambda_base_color_smooth=0.1, lambda_roughness_smooth=0.05,
        lambda_env_smooth=0.02)
    state, _, env_state, bake, _ = train_stage2(
        state, train_cams, opt2, bg=(0, 0, 0), raster_cfg=cfg,
        sample_num=sample_num, env_resolution=16,
        first_iter=stage1_iters, iterations=stage1_iters + stage2_iters,
        log_every=100, seed=seed, device=device)

    p2, alive = state["params"], state["alive"]
    with torch.no_grad():
        vals = [_psnr(render_svgss(cam, p2, bg, bake=bake,
                                   env_params=env_state["params"],
                                   opt=OptimizationConfig(),
                                   is_training=False, alive=alive,
                                   cfg=cfg)["pbr"], cam.image)
                for cam in test_cams]
    out["stage2_pbr_psnr"] = float(np.mean(vals))
    if verbose:
        print(f"stage2: test pbr psnr {out['stage2_pbr_psnr']:.2f}",
              flush=True)

    # ---- relight under env2 (the eval_relighting flow) -------------------
    az_rel = torch.rand(int(alive.sum()), 1, generator=gen).to(device)
    with torch.no_grad():
        p_rel, bake2 = _eval_params(state, env2, sample_num, az_rel)
        gt_p, gt_bake = _eval_params(gt_state, env2, sample_num, az_gt)
    env2_fn, _ = _env_fns(env2)

    def render(cam, p, b, a, bcs=None):
        return render_svgss(cam, p, bg, bake=b, env_params=None,
                            env_fn=env2_fn, opt=OptimizationConfig(),
                            is_training=False, alive=a, cfg=cfg,
                            base_color_scale=bcs)

    with torch.no_grad():
        # the median albedo rescale on the first test view against the
        # TRUE model's albedo buffer (eval_relighting_tensoIR.py:197-241)
        r0 = render(test_cams[0], p_rel, bake2, alive)
        gt_r0 = render(test_cams[0], gt_p, gt_bake, gt_state["alive"])
        scale = calibrate_albedo_scale(r0["base_color"], gt_r0["base_color"],
                                       test_cams[0].image_mask)
        vals, vals_albedo = [], []
        for cam, gt_cam in zip(test_cams, gt2_test):
            r = render(cam, p_rel, bake2, alive, scale)
            vals.append(_psnr(r["pbr"], gt_cam.image))
            # the albedo buffer against the TRUE model's (the relight
            # flow's own metric, eval_relighting_tensoIR.py:367-409)
            gt_r = render(cam, gt_p, gt_bake, gt_state["alive"])
            vals_albedo.append(_psnr(r["base_color"], gt_r["base_color"]))
    out["relight_psnr"] = float(np.mean(vals))
    out["albedo_psnr"] = float(np.mean(vals_albedo))
    if verbose:
        print(f"relight: psnr vs GT under env2 {out['relight_psnr']:.2f} "
              f"albedo {out['albedo_psnr']:.2f}", flush=True)
    return out
