"""The learnable environment map (DirectLightMap) of stage 2.

Reference: ``scene/direct_light_map.py`` and ``svgir_tpu.models.lights``:
an H x 2H equirect map, softplus activation, ``grid_sample``
(align_corners) lookup x 2.0, its own Adam.  The lookup is kernel B7
(``ops/env_lookup_pallas.py``), differentiable with respect to the env
only.  The fixed HDR light (EnvLight), the map's upsampling and the
SG / SH / gamma lights are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from svgir_tpu_torch.ops.env_lookup_pallas import bilinear_lookup
from svgir_tpu_torch.train import optim


def _bilinear_lookup(img: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """align_corners bilinear sample of img [H, W, C] at pixel coordinates
    u, v [...] (u in [0, W-1], v in [0, H-1]) -> [..., C]."""
    shape = u.shape
    out = bilinear_lookup(img, u.reshape(-1), v.reshape(-1))
    return out.reshape(*shape, img.shape[2])


def equirect_grid_coords(dirs: torch.Tensor):
    """(qx, qy) grid coordinates in [-1, 1] of unit ``dirs`` [..., 3]
    (direct_light_map.py:70-83): phi = arccos(z) - 1e-6,
    theta = atan2(y, x), qx = -theta/pi, qy = phi/pi*2 - 1.  A bake
    stores them for its constant incident directions (``incident_qxy``)."""
    z = torch.clamp(dirs[..., 2], -1.0, 1.0)
    phi = torch.arccos(z) - 1e-6
    theta = torch.atan2(dirs[..., 1], dirs[..., 0])
    return -theta / math.pi, (phi / math.pi) * 2 - 1


def _equirect_query(dirs: torch.Tensor, h: int, w: int):
    """Pixel-coordinate equirect query (align_corners)."""
    qx, qy = equirect_grid_coords(dirs)
    return (qx + 1) * 0.5 * (w - 1), (qy + 1) * 0.5 * (h - 1)


def env_activated(params) -> torch.Tensor:
    """softplus activation (direct_light_map.py:103-106): [H, W, 3]."""
    return F.softplus(params["env"])


def direct_light_qxy(params, qx: torch.Tensor,
                     qy: torch.Tensor) -> torch.Tensor:
    """``direct_light`` from precomputed grid coordinates."""
    env = env_activated(params)
    h, w = env.shape[0], env.shape[1]
    return _bilinear_lookup(env, (qx + 1) * 0.5 * (w - 1),
                            (qy + 1) * 0.5 * (h - 1)) * 2.0


def direct_light(params, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance lookup x 2.0 (direct_light_map.py:70-83)."""
    env = env_activated(params)
    u, v = _equirect_query(dirs, env.shape[0], env.shape[1])
    return _bilinear_lookup(env, u, v) * 2.0


def direct_light_map_init(h: int = 128, light_init: float = 0.5, *,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> Dict[str, Any]:
    """env ~ light_init * U[0, 1), shape [H, 2H, 3]
    (direct_light_map.py:11-16), with its Adam state.  The draw comes from
    ``generator`` (on ``device``)."""
    env = light_init * torch.rand(h, 2 * h, 3, generator=generator,
                                  device=device)
    params = {"env": env}
    return {"params": params, "opt": optim.adam_init(params)}


def direct_light_map_step(state: Dict, grads: Dict, env_lr: float) -> Dict:
    params, opt_state = optim.adam_step(state["params"], grads, state["opt"],
                                        {"env": env_lr})
    return {"params": params, "opt": opt_state}


def env_state_from_jax(np_state: Mapping[str, Any],
                       device="cuda") -> Dict[str, Any]:
    """A ``svgir_tpu`` DirectLightMap state (values as numpy arrays, e.g.
    from ``jax.device_get``) -> the same state as tensors on ``device``."""
    def tensors(d):
        return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in d.items()}
    opt = np_state["opt"]
    return {"params": tensors(np_state["params"]),
            "opt": {"m": tensors(opt["m"]), "v": tensors(opt["v"]),
                    "step": int(opt["step"])}}

