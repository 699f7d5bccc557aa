"""Gaussian-surfel model state: parameters, activations, initialization and
the densification statistics.

The state mirrors ``svgir_tpu.models.gaussians``: a dict with "params" (a
dict of tensors with the JAX pytree's keys and shapes), "alive" (a [cap]
bool mask over a fixed capacity) and "stats".  ``params_from_jax`` and
``params_to_numpy`` carry the JAX state (as numpy arrays) across so both
packages compute the same thing in the tests.

The stage-2 groups (per-vertex base color, roughness and normal offsets,
the baked radiances and their ratio) come from ``upgrade_to_pbr`` and the
stage-2 trainer.  Densification (``densify_and_prune``, ``reset_opacity``,
``grow_capacity``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from svgir_tpu_torch.utils.sh import rgb_to_sh
from svgir_tpu_torch.utils.transforms import (inverse_sigmoid, normal_to_rotation,
                                              normalize, quat_to_rotmat)

VERTEX_NUM = 4  # gaussian_model.py:150

# ---------------------------------------------------------------------------
# activations (gaussian_model.py:104-125, 270-351)
# ---------------------------------------------------------------------------


def get_scaling(params) -> torch.Tensor:
    return torch.nan_to_num(torch.exp(params["scaling"]), nan=1e-6)


def get_rotation(params) -> torch.Tensor:
    return torch.nan_to_num(normalize(params["rotation"]), nan=1e-6)


def get_opacity(params) -> torch.Tensor:
    return torch.sigmoid(params["opacity"])


def get_geo_normal(params) -> torch.Tensor:
    """3rd column of the rotation matrix (gaussian_model.py:297-299)."""
    return quat_to_rotmat(get_rotation(params))[..., :, 2]


def get_shs(params) -> torch.Tensor:
    return torch.cat([params["shs_dc"], params["shs_rest"]], 1)


def get_shading_normal(params) -> torch.Tensor:
    """[N, 4, 3] per-vertex normals: geo normal + offsets, normalized
    (gaussian_model.py:287-295).  ``normal`` holds channel-major offsets
    [cx*4, cy*4, cz*4]."""
    geo = get_geo_normal(params)[:, None, :]                     # [N, 1, 3]
    off = params["normal"].reshape(-1, 3, VERTEX_NUM).transpose(1, 2)
    return normalize(geo + off)


def get_base_color(params) -> torch.Tensor:
    """sigmoid(x)*0.77 + 0.03, channel-major over the 4 vertices
    (gaussian_model.py:123; the relighting's per-channel rescale is not
    ported yet)."""
    return torch.sigmoid(params["base_color"]) * 0.77 + 0.03


def get_roughness(params) -> torch.Tensor:
    return torch.nan_to_num(torch.sigmoid(params["roughness"]) * 0.9 + 0.09,
                            nan=1e-8)


def get_radiances(params) -> torch.Tensor:
    """Baked radiance, detached, times the trainable ratio
    (gaussian_model.py:322-324): ``radiances`` trains only through the
    consistency loss, ``radiance_ratio`` through the rendered PBR loss."""
    return torch.nan_to_num(
        params["radiances"].detach() * params["radiance_ratio"], nan=0.0)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _round_capacity(n: int) -> int:
    cap = 4096
    while cap < n:
        cap *= 2
    return cap


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def init_from_points(points, colors, normals=None, *, sh_degree: int = 3,
                     capacity: Optional[int] = None, mean_sq_dist=None,
                     rotation_init: str = "identity",
                     device="cuda") -> Dict[str, Any]:
    """create_from_pcd (gaussian_model.py:695-735) with padded capacity.

    ``mean_sq_dist``: mean squared distance to the 3 nearest neighbours
    (simple-knn distCUDA2); computed brute-force when not given.
    """
    points = _as_tensor(points, device)
    colors = _as_tensor(colors, device)
    normals = None if normals is None else _as_tensor(normals, device)
    n = points.shape[0]
    cap = capacity or _round_capacity(n)
    k = (sh_degree + 1) ** 2

    if mean_sq_dist is None:
        from svgir_tpu_torch.ops.knn import mean_sq_dist_3nn
        mean_sq_dist = mean_sq_dist_3nn(points)
    dist2 = torch.clamp(_as_tensor(mean_sq_dist, device), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=device)
        out[:n] = x
        return out

    shs = torch.zeros(n, k, 3, device=device)
    shs[:, 0, :] = rgb_to_sh(colors)

    if rotation_init == "normal" and normals is not None:
        rots = normal_to_rotation(normals)
    else:  # reference default: identity (gaussian_model.py:708-709)
        rots = torch.zeros(n, 4, device=device)
        rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones(n, 1, device=device))
    if normals is None:
        normals = torch.zeros(n, 3, device=device)

    params = {
        "xyz": pad(points),
        "normal": pad(normals),
        "shs_dc": pad(shs[:, 0:1, :]),
        "shs_rest": pad(shs[:, 1:, :]),
        "scaling": pad(scales),
        "rotation": pad(rots),
        "opacity": pad(opac, fill=-10.0),
    }
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return {"params": params, "alive": alive,
            "stats": init_stats(cap, device=device)}


def pbr_init(cap: int, sh_degree: int = 3,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Per-vertex PBR parameters of the stage-1 -> stage-2 upgrade
    (gaussian_model.py:667-684), all zeros; ``upgrade_to_pbr`` replaces
    ``normal`` by [cap, 12] per-vertex offsets."""
    k = (sh_degree + 1) ** 2
    return {
        "base_color": torch.zeros(cap, 3 * VERTEX_NUM, device=device),
        "roughness": torch.zeros(cap, VERTEX_NUM, device=device),
        "incidents_dc": torch.zeros(cap, 1, 3, device=device),
        "incidents_rest": torch.zeros(cap, k - 1, 3, device=device),
        "visibility_dc": torch.zeros(cap, 1, 1, device=device),
        "visibility_rest": torch.zeros(cap, 15, 1, device=device),
    }


def upgrade_to_pbr(state: Dict[str, Any]) -> Dict[str, Any]:
    """Stage 1 -> stage 2 (create_from_ckpt, from_gs path,
    gaussian_model.py:667-684): add the per-vertex parameters and replace
    the [cap, 3] normal by zeroed [cap, 12] per-vertex offsets.  The new
    tensors go where ``xyz`` lies."""
    params = dict(state["params"])
    cap, dev = params["xyz"].shape[0], params["xyz"].device
    params.update(pbr_init(cap, device=dev))
    params["normal"] = torch.zeros(cap, 3 * VERTEX_NUM, device=dev)
    return {**state, "params": params}


def init_stats(cap: int, device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "xyz_gradient_accum": torch.zeros(cap, 1, device=device),
        "normal_gradient_accum": torch.zeros(cap, 1, device=device),
        "denom": torch.zeros(cap, 1, device=device),
        "weights_accum": torch.zeros(cap, 1, device=device),
        "max_radii2d": torch.zeros(cap, device=device),
    }


def add_densification_stats(stats, mean2d_grad_ndc, update_filter, weights,
                            radii):
    """train.py:194-199 + gaussian_model.py:1270-1276.  ``mean2d_grad_ndc``
    is the screen-position gradient scaled to NDC (x 0.5 W, 0.5 H)."""
    upd = update_filter[:, None]
    zero = torch.zeros((), device=weights.device)
    stats = dict(stats)
    stats["weights_accum"] = stats["weights_accum"] + weights
    stats["xyz_gradient_accum"] = stats["xyz_gradient_accum"] + torch.where(
        upd, mean2d_grad_ndc.norm(dim=-1, keepdim=True), zero)
    stats["denom"] = stats["denom"] + upd.to(torch.float32)
    stats["max_radii2d"] = torch.where(
        update_filter, torch.maximum(stats["max_radii2d"], radii),
        stats["max_radii2d"])
    return stats


# ---------------------------------------------------------------------------
# exchange with svgir_tpu (numpy at the boundary)
# ---------------------------------------------------------------------------

def params_from_jax(np_params: Mapping[str, Any],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Parameter dict of the JAX state (values as numpy arrays, e.g. from
    ``jax.device_get``) -> the same keys as float32 tensors on ``device``.
    Covers the stage-2 groups too, the 0-d ``radiance_ratio`` included."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in np_params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: tensors -> numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
