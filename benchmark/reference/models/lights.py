"""The learnable env map of stage 2 (direct_light_map.py): an equirect
map [H, 2H, 3] through softplus, looked up by align_corners bilinear
sampling (``ops/env_lookup_pallas.py``), differentiable with respect to
the map, with its own Adam step.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.ops.env_lookup_pallas import bilinear_lookup
from reference.train import optim


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


def direct_light_map_step(state: Dict, grads: Dict, env_lr: float) -> Dict:
    params, opt_state = optim.adam_step(state["params"], grads, state["opt"],
                                        {"env": env_lr})
    return {"params": params, "opt": opt_state}

