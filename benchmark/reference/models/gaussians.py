"""Gaussian-surfel activations (gaussian_model.py:104-125, 270-351), as
``svgir_tpu.models.gaussians`` forms them.  The state is a dict with
"params" (a dict of tensors) and "alive" (a [cap] bool mask).
"""

from __future__ import annotations

from typing import Optional

import torch

from reference.utils.transforms import normalize, quat_to_rotmat


VERTEX_NUM = 4  # gaussian_model.py:150


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


def get_base_color(params, base_color_scale: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """sigmoid(x)*0.77 + 0.03, channel-major over the 4 vertices, optionally
    rescaled per colour channel [3] (gaussian_model.py:123, 338-339; the
    relighting evaluation's albedo calibration)."""
    bc = torch.sigmoid(params["base_color"]) * 0.77 + 0.03
    if base_color_scale is not None:
        bc = bc * torch.repeat_interleave(base_color_scale, VERTEX_NUM)[None]
    return bc


def get_roughness(params) -> torch.Tensor:
    return torch.nan_to_num(torch.sigmoid(params["roughness"]) * 0.9 + 0.09,
                            nan=1e-8)


def get_radiances(params) -> torch.Tensor:
    """Baked radiance, detached, times the trainable ratio
    (gaussian_model.py:322-324): ``radiances`` trains only through the
    consistency loss, ``radiance_ratio`` through the rendered PBR loss."""
    return torch.nan_to_num(
        params["radiances"].detach() * params["radiance_ratio"], nan=0.0)

