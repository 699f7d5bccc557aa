"""Relighting evaluation (``eval_relighting_tensoIR.py``).

Mirrors ``svgir_tpu.eval.relighting``.  For each new HDR light:

1. bake the hemisphere buffers (light-independent: a sweep over lights
   bakes once and passes ``bake``),
2. re-bake ``radiances`` as the one-bounce irradiance under the new light
   (``irradiance_full``; calculate_radiance + update_radiance_with_calc),
3. calibrate a per-channel albedo scale on the first view (the median of
   GT / predicted albedo over its mask) when albedo ground truth exists,
4. render every view in eval mode with the fixed light and score pbr
   (PSNR / SSIM / MSE / LPIPS), albedo and normals; write the images and
   ``<light>/metrics.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.eval import metrics as M
from svgir_tpu_torch.eval.nvs import save_image, to_numpy, warn_overflow
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.models import radiance as RAD
from svgir_tpu_torch.render.svgss import render_svgss
from svgir_tpu_torch.train.staging import stage_cameras
from svgir_tpu_torch.train.trainer import bake_radiance_compact, strip_meta


K_HITS = 16    # the reference's relighting bake: bake_radiance's default


def bake_hemisphere(params, alive, *, sample_num: int,
                    azimuth: Optional[torch.Tensor] = None,
                    use_grid: Optional[bool] = None) -> Dict:
    """Step 1: the hemisphere bake over the alive surfels, one pass at
    ``K_HITS`` as the reference bakes it (rays that use up the list keep
    their truncated radiance: no re-bake at a larger k).  ``azimuth``
    [n_alive, 1] turns the spirals (the reference's ``key``; unturned
    without it); ``use_grid`` as ``bake_radiance_compact``'s."""
    return bake_radiance_compact(params, alive, sample_num=sample_num,
                                 azimuth=azimuth, k_hits=K_HITS,
                                 max_k_hits=K_HITS, use_grid=use_grid)


def calibrate_albedo_scale(pred_albedo, gt_albedo, mask) -> torch.Tensor:
    """Per-channel median of GT / predicted albedo over the pixels where
    mask [1, H, W] > 0.5 (eval_relighting_tensoIR.py:237-241); [3] on the
    prediction's device."""
    m = to_numpy(mask)[0] > 0.5
    pred = to_numpy(pred_albedo)[:, m]
    gt = to_numpy(gt_albedo)[:, m]
    ratio = np.median(gt / np.clip(pred, 1e-6, None), axis=1)
    return torch.as_tensor(ratio.astype(np.float32),
                           device=pred_albedo.device)


@torch.no_grad()
def rebake_radiance_for_light(params, alive, env_state: Dict, *,
                              sample_num: int,
                              azimuth: Optional[torch.Tensor] = None,
                              bake: Optional[Dict] = None):
    """Steps 1 and 2: the hemisphere bake (``bake_hemisphere``: fibonacci
    directions, unturned unless ``azimuth`` is given; ``bake`` from an
    earlier call on the same geometry skips it), then the radiances
    [N, S, 3] as the one-bounce irradiance under the light ``env_state``.
    Returns (bake, radiances)."""
    if bake is None:
        bake = bake_hemisphere(params, alive, sample_num=sample_num,
                               azimuth=azimuth)
    env_term = LT.env_light_direct(env_state, bake["incident_dirs"]) \
        * bake["incident_areas"]
    n = params["xyz"].shape[0]
    albedo = G.get_base_color(params).reshape(n, 3, 4).transpose(1, 2)
    radiances = RAD.irradiance_full(bake, env_term,
                                    G.get_shading_normal(params), albedo,
                                    G.get_roughness(params)[:, 0])
    return bake, radiances


@torch.no_grad()
def eval_relighting(out_dir: str, params, alive, env_state: Dict,
                    cameras: List, *, sample_num: int = 384,
                    raster_cfg: RasterConfig = RasterConfig(),
                    gt_albedo_fn=None, lpips_weights=None,
                    bg=(0.0, 0.0, 0.0), light_name: str = "env",
                    bake: Optional[Dict] = None) -> Dict:
    """Relight ``params`` under ``env_state`` (``lights.env_light_init``)
    and score ``cameras``; writes ``<out_dir>/<light_name>/`` (per view
    ``<idx>_{pbr,base_color,visibility,local_lights}.png`` and
    ``metrics.json``: the mean of each per-view metric, LPIPS or its
    note, and ``n_views``).  ``gt_albedo_fn(idx)`` -> (albedo [3, H, W],
    mask [1, H, W]) adds the calibration and the albedo metrics."""
    dev = params["xyz"].device
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    bake, radiances = rebake_radiance_for_light(
        params, alive, env_state, sample_num=sample_num, bake=bake)
    params = {**params, "radiances": radiances,
              "radiance_ratio": torch.ones((), device=dev)}
    bake_static = {k: v for k, v in bake.items() if k != "exhausted_frac"}

    def env_fn(dirs):
        return LT.env_light_direct(env_state, dirs)

    env_qxy_fn = None       # the precomputed coordinates need no transform
    if env_state.get("transform") is None:
        def env_qxy_fn(q):
            return LT.env_light_direct_qxy(env_state, q[..., 0], q[..., 1])

    def render(cam, bcs):
        return render_svgss(cam, params, bg, bake=bake_static,
                            env_params=None, env_fn=env_fn,
                            env_qxy_fn=env_qxy_fn, opt=OptimizationConfig(),
                            is_training=False, alive=alive, cfg=raster_cfg,
                            base_color_scale=bcs)

    base_color_scale = torch.ones(3, device=dev)
    rows = []
    warned = False
    os.makedirs(os.path.join(out_dir, light_name), exist_ok=True)
    for idx, cam in enumerate(cameras):
        cam = stage_cameras([strip_meta(cam)], device=dev)[0]
        res = render(cam, base_color_scale)
        warned = warned or warn_overflow(res, light_name, idx)
        if idx == 0 and gt_albedo_fn is not None:
            gt_albedo, mask = gt_albedo_fn(0)
            base_color_scale = calibrate_albedo_scale(res["base_color"],
                                                      gt_albedo, mask)
            res = render(cam, base_color_scale)

        row = {}
        if cam.image is not None:
            pbr = torch.clamp(res["pbr"], 0, 1)
            row.update({f"pbr_{k}": v for k, v in
                        M.image_metrics(pbr, cam.image).items()})
            lp = M.lpips(pbr, cam.image, lpips_weights)
            if lp is not None:
                row["pbr_lpips"] = lp
        if gt_albedo_fn is not None:
            gt_albedo, mask = gt_albedo_fn(idx)
            row.update({f"albedo_{k}": v for k, v in M.image_metrics(
                torch.clamp(res["base_color"], 0, 1), gt_albedo).items()})
        if cam.normal is not None:
            row["normal_mse"] = M.mse(res["normal"], cam.normal)
            row["normal_mae_deg"] = M.normal_mae_deg(
                res["normal"], cam.normal, cam.image_mask)
        rows.append(row)

        for key in ("pbr", "base_color", "visibility", "local_lights"):
            if key in res:
                save_image(os.path.join(out_dir, light_name,
                                        f"{idx:05d}_{key}.png"),
                           torch.clamp(res[key], 0, 1))

    summary: Dict[str, object] = {}
    for key in (rows[0] if rows else ()):
        summary[key] = float(np.mean([r[key] for r in rows if key in r]))
    available, note = M.lpips_status(lpips_weights)
    if not available:
        # never a silently missing column
        summary["pbr_lpips"] = note
        summary["albedo_lpips"] = note
    summary["n_views"] = len(rows)
    with open(os.path.join(out_dir, light_name, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
