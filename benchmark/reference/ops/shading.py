"""Physically based per-vertex shading (the deferred-PBR stage).

Reference: ``gaussian_renderer/svgss.py`` ``rendering_equation4``
(:537-593) and ``GGX_specular4`` (:595-630), as ``svgir_tpu.ops.shading``
transcribes them.  Shading runs per surfel vertex (4 per surfel) over S
precomputed incident directions, before rasterization; the rasterizer then
blends the 12-channel results bilinearly.  Constants: global light clamp
[0, 64], fresnel 0.04, k = (alpha + 2 r + 1) / 8, Schlick
2^((-5.55473 VoH - 6.98316) VoH), denominator clamp [1e-6, 4 pi].  Vertex
channels are channel-major: [c0v0..c0v3, c1v0..].
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference.utils.transforms import normalize


def ggx_specular4(normal: torch.Tensor, pts2c: torch.Tensor,
                  pts2l: torch.Tensor, roughness: torch.Tensor,
                  fresnel: float = 0.04) -> torch.Tensor:
    """GGX specular per (sample, vertex).  normal [N, 4, 3]; pts2c [N, 3];
    pts2l [N, S, 3]; roughness [N, 4] -> [N, S, 4, 1]."""
    L = normalize(pts2l)[:, :, None, :]                  # [N, S, 1, 3]
    V = normalize(pts2c)[:, None, :]                     # [N, 1, 3]
    H = normalize((L + V[:, None]) / 2.0)                # [N, S, 1, 3]
    N = normalize(normal)                                # [N, 4, 3]

    NoV = (V * N).sum(-1, keepdim=True)                  # [N, 4, 1]
    N = N * torch.sign(NoV)

    NoL = torch.clamp((N[:, None] * L).sum(-1, keepdim=True), 1e-6, 1)
    NoV = torch.clamp((N * V).sum(-1, keepdim=True), 1e-6, 1)
    NoH = torch.clamp((N[:, None] * H).sum(-1, keepdim=True), 1e-6, 1)
    VoH = torch.clamp((V[:, None] * H).sum(-1, keepdim=True), 1e-6, 1)

    rough = roughness[:, None, :, None]                  # [N, 1, 4, 1]
    alpha = rough * rough
    alpha2 = alpha * alpha
    k = (alpha + 2 * rough + 1.0) / 8.0
    fmi = ((-5.55473) * VoH - 6.98316) * VoH
    frac0 = fresnel + (1 - fresnel) * torch.pow(2.0, fmi)
    frac = frac0 * alpha2
    nom0 = NoH * NoH * (alpha2 - 1) + 1
    nom1 = NoV[:, None] * (1 - k) + k
    nom2 = NoL * (1 - k) + k
    nom = torch.clamp(4 * math.pi * nom0 * nom0 * nom1 * nom2, 1e-6,
                      4 * math.pi)
    return frac / nom


def rendering_equation4(base_color: torch.Tensor, roughness: torch.Tensor,
                        normals: torch.Tensor, viewdirs: torch.Tensor,
                        radiance: torch.Tensor, env_direct_light,
                        visibility: torch.Tensor, incident_dirs: torch.Tensor,
                        incident_areas: torch.Tensor,
                        env_radiance: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, Dict]:
    """Per-vertex rendering equation (svgss.py:537-593).

    base_color [N, 12] channel-major; roughness [N, 4]; normals [N, 4, 3];
    viewdirs [N, 3] (points -> camera); radiance [N, S, 3] (baked local
    incident light); env_direct_light: fn(dirs [N, S, 3]) -> [N, S, 3];
    visibility [N, S, 1]; incident_dirs [N, S, 3]; incident_areas
    [N, S, 1]; env_radiance: env_direct_light(incident_dirs) evaluated by
    the caller, who shares it with the consistency loss.

    Returns (pbr [N, 12], dict of the intermediate terms).
    """
    if env_radiance is None:
        env_radiance = env_direct_light(incident_dirs)
    local_lights = radiance
    global_lights = torch.clamp(env_radiance, 0.0, 64.0) * visibility
    incident_lights = local_lights + global_lights          # [N, S, 3]

    # n.l per (sample, vertex): [N, S, 4, 1]
    n_d_i = torch.clamp((normals[:, None] * incident_dirs[:, :, None]).sum(
        -1, keepdim=True), min=0)
    f_d = base_color[:, None] / math.pi                     # [N, 1, 12]
    f_s = ggx_specular4(normals, viewdirs, incident_dirs, roughness)
    # [N, S, 4, 1] -> [N, S, 4] tiled x3 = channel-major [N, S, 12]
    f_s = f_s[..., 0].repeat(1, 1, 3)

    def fold(lights):
        t = lights[:, :, None] * incident_areas[:, :, None] * n_d_i
        return t.transpose(2, 3).reshape(t.shape[0], t.shape[1], -1)

    transport = fold(incident_lights)                        # [N, S, 12]
    specular = (f_s * transport).mean(-2)
    pbr = ((f_d + f_s) * transport).mean(-2)
    diffuse_light = transport.mean(-2)

    direct_pbr = ((f_d + f_s) * fold(global_lights)).mean(-2)
    indirect_pbr = ((f_d + f_s) * fold(local_lights)).mean(-2)

    extra = {
        "incident_dirs": incident_dirs,
        "incident_lights": incident_lights,
        "local_incident_lights": local_lights,
        "global_incident_lights": global_lights,
        "incident_visibility": visibility,
        "diffuse_light": diffuse_light,
        "specular": specular,
        "direct": direct_pbr,
        "indirect": indirect_pbr,
    }
    return pbr, extra
