"""Per-group Adam with the reference optimizer's semantics.

torch.optim.Adam(eps=1e-15) with named parameter groups and per-group
learning rates (gaussian_model.py:737-773) and NaN-gradient scrubbing
(replace_nangrad_to_zero, gaussian_model.py:775-795), written as a
functional step over dicts of tensors like ``svgir_tpu.train.optim``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference.config import OptimizationConfig

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15

# NaN gradients are replaced per group: 1e-6 for scaling/rotation, 0 else
_NAN_FILL = {"scaling": 1e-6, "rotation": 1e-6, "roughness": 1e-6}


def group_lrs(opt: OptimizationConfig, spatial_lr_scale: float,
              use_pbr: bool = False) -> Dict[str, float]:
    """Static per-group learning rates (xyz is overridden per step by the
    schedule; stage 2 also overrides ``radiances`` per step).  ``use_pbr``
    adds the stage-2 groups."""
    lrs = {
        "xyz": opt.position_lr_init * spatial_lr_scale,
        "normal": opt.normal_lr,
        "rotation": opt.rotation_lr,
        "scaling": opt.scaling_lr,
        "opacity": opt.opacity_lr,
        "shs_dc": opt.sh_lr,
        "shs_rest": opt.sh_lr / 20.0,
    }
    if use_pbr:
        light_rest = opt.light_rest_lr if opt.light_rest_lr >= 0 \
            else opt.light_lr / 20.0
        vis_rest = opt.visibility_rest_lr if opt.visibility_rest_lr >= 0 \
            else opt.visibility_lr / 20.0
        lrs.update({
            "base_color": opt.base_color_lr,
            "roughness": opt.roughness_lr,
            "incidents_dc": opt.light_lr,
            "incidents_rest": light_rest,
            "visibility_dc": opt.visibility_lr,
            "visibility_rest": vis_rest,
            "radiances": opt.radiance_lr,
            "radiance_ratio": opt.radiance_ratio_lr,
        })
    return lrs


def adam_init(params: Dict[str, torch.Tensor]) -> Dict:
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "step": 0}


@torch.no_grad()
def adam_step(params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: Dict,
              lrs: Dict[str, float]) -> tuple[Dict, Dict]:
    """One Adam step with NaN scrubbing; returns new dicts (inputs are not
    modified)."""
    step = state["step"] + 1
    # bias corrections in float32, as svgir_tpu forms them (in double they
    # differ by 6e-6 relative at step 1: float32(0.999) is not 0.999)
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(BETA1) ** f32(step))
    bc2 = float(f32(1.0) - f32(BETA2) ** f32(step))
    new_params, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            new_params[k], new_m[k], new_v[k] = p, state["m"][k], state["v"][k]
            continue
        g = torch.nan_to_num(g, nan=_NAN_FILL.get(k, 0.0), posinf=0.0,
                             neginf=0.0)
        m = BETA1 * state["m"][k] + (1 - BETA1) * g
        v = BETA2 * state["v"][k] + (1 - BETA2) * g * g
        new_params[k] = p - lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_m[k], new_v[k] = m, v
    return new_params, {"m": new_m, "v": new_v, "step": step}
