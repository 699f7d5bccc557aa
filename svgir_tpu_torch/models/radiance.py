"""The per-step part of the radiance model: the one-bounce irradiance at one
chosen sample per surfel and the radiance-consistency loss of the stage-2
step.

Mirrors ``svgir_tpu.models.radiance`` (reference
``gaussian_model.py:544-575`` and ``intersect_test.slang:1143-1378``).
The bake that produces the buffers (``bake_radiance``: hemisphere samples,
visibility, first hits and their uv, baked radiance) and the full-S
``irradiance_full`` are not ported yet; the step takes a bake as input.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.utils.transforms import normalize


def shading_brdf_simple(view_dir, light_dir, normal, albedo, roughness):
    """pbr.slang:282-328: diffuse albedo/pi + GGX (fresnel 0.04).  All
    arguments broadcast, [..., 3] / [...]."""
    N = normalize(normal)
    V = normalize(view_dir)
    L = normalize(light_dir)
    H = normalize(V + L)
    NoL = torch.clamp((N * L).sum(-1, keepdim=True), 1e-6, 1)
    NoV = torch.clamp((N * V).sum(-1, keepdim=True), 1e-6, 1)
    NoH = torch.clamp((N * H).sum(-1, keepdim=True), 1e-6, 1)
    VoH = torch.clamp((V * H).sum(-1, keepdim=True), 1e-6, 1)
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2.0 * roughness + 1.0) / 8.0
    fmi = (-5.55473 * VoH - 6.98316) * VoH
    frac0 = 0.04 + 0.96 * torch.pow(2.0, fmi)
    frac = frac0 * alpha2
    nom0 = NoH * NoH * (alpha2 - 1.0) + 1.0
    nom1 = NoV * (1.0 - k) + k
    nom2 = NoL * (1.0 - k) + k
    nom = torch.clamp(4 * math.pi * nom0 * nom0 * nom1 * nom2, 1e-6,
                      4 * math.pi)
    return frac / nom + albedo / math.pi


def _hit_table(bake: Dict, env_term: torch.Tensor,
               vertex_normals: torch.Tensor, vertex_albedo: torch.Tensor,
               roughness: torch.Tensor) -> torch.Tensor:
    """[N, 9S+25] per-surfel rows for the one-bounce shading: the surfel's
    own sample set (dirs, hits, uv, env term), its vertex normals (no
    gradient) and albedo, and its roughness.  One wide gather by first-hit
    index reads them all; its backward is one scatter-add."""
    n = bake["hit_idx"].shape[0]
    return torch.cat([
        bake["incident_dirs"].reshape(n, -1),                # 3S
        bake["hit_idx"].to(torch.float32),                   # S (exact)
        bake["uv"].reshape(n, -1),                           # 2S
        env_term.reshape(n, -1),                             # 3S
        vertex_normals.detach().reshape(n, -1),              # 12
        vertex_albedo.reshape(n, -1),                        # 12
        roughness[:, None],                                  # 1
    ], dim=1)


def _irradiance_from_table(table: torch.Tensor, pri_dir: torch.Tensor,
                           hit: torch.Tensor, s: int) -> torch.Tensor:
    """One-bounce irradiance [N, 3] for hits [N] along primary directions
    [N, 3], reading the hit surfels' rows of ``table``."""
    n = hit.shape[0]
    no_hit = hit < 0
    g = table[torch.clamp(hit, 0, table.shape[0] - 1).long()]
    cols = iter(torch.split(g, [3 * s, s, 2 * s, 3 * s, 12, 12, 1], dim=1))
    sec_dirs = normalize(next(cols).reshape(n, s, 3))        # [N, S, 3]
    unoccluded = next(cols) < 0                              # [N, S]
    uv = next(cols).reshape(n, s, 2)
    env_term_h = next(cols).reshape(n, s, 3)
    normals_h = next(cols).reshape(n, 4, 3)
    albedo_h = next(cols).reshape(n, 4, 3)
    rough_h = next(cols).reshape(n, 1, 1, 1)

    u0, u1 = uv[..., 0], uv[..., 1]
    wv = torch.stack([(1 - u0) * (1 - u1), u0 * (1 - u1), (1 - u0) * u1,
                      u0 * u1], -1)                          # [N, S, 4]
    irr_v = shading_brdf_simple(
        -pri_dir[:, None, None], sec_dirs[:, :, None],
        normals_h[:, None], albedo_h[:, None], rough_h)      # [N, S, 4, 3]
    irr = (wv[..., None] * irr_v).sum(2)                     # [N, S, 3]

    contrib = irr * env_term_h / s
    contrib = torch.where(unoccluded[..., None], contrib,
                          torch.zeros_like(contrib))
    total = contrib.sum(1)
    return torch.where(no_hit[:, None], torch.zeros_like(total), total)


def irradiance_sample(sample_idx: torch.Tensor, bake: Dict,
                      env_term: torch.Tensor, vertex_normals: torch.Tensor,
                      vertex_albedo: torch.Tensor,
                      roughness: torch.Tensor) -> torch.Tensor:
    """One-bounce irradiance [N, 3] at one chosen sample per surfel
    (render_irradiance_sample).  sample_idx [N]; env_term [N, S, 3] (env
    radiance x incident area); vertex_normals [N, 4, 3]; vertex_albedo
    [N, 4, 3]; roughness [N] (vertex 0)."""
    n, s = bake["hit_idx"].shape
    gidx = torch.arange(n, device=sample_idx.device)
    pri_dir = bake["incident_dirs"][gidx, sample_idx]        # [N, 3]
    hit = bake["hit_idx"][gidx, sample_idx]                  # [N]
    table = _hit_table(bake, env_term, vertex_normals, vertex_albedo,
                       roughness)
    return _irradiance_from_table(table, pri_dir, hit, s)


def radiance_consistency_loss(params, bake: Dict, cam_center: torch.Tensor,
                              env_direct_light, *, alive=None,
                              env_radiance=None) -> torch.Tensor:
    """get_radiance_loss (gaussian_model.py:544-575): pick the sample that
    maximizes (reflected view . dir) * (1 - visibility), trace the
    differentiable one bounce there, L1 against the stored radiance.
    ``env_radiance``: env_direct_light(incident_dirs), shared with the
    shading's lookup."""
    xyz = params["xyz"]
    n = xyz.shape[0]
    if env_radiance is None:
        env_radiance = env_direct_light(bake["incident_dirs"])
    env_term = env_radiance * bake["incident_areas"]

    view_dirs = normalize(xyz - cam_center[None])
    geo_n = G.get_geo_normal(params)
    view_reflect = 2 * (geo_n * view_dirs).sum(-1, keepdim=True) * geo_n \
        + view_dirs
    n_d_i = (bake["incident_dirs"] * view_reflect[:, None]).sum(-1)
    occ = 1 - bake["visibility"][..., 0]
    sample_idx = torch.argmax(n_d_i * occ, dim=-1)           # first maximum

    vertex_normals = G.get_shading_normal(params)            # [N, 4, 3]
    # albedo [N, 12] channel-major -> [N, 4, 3] vertex-major
    albedo = G.get_base_color(params).reshape(n, 3, 4).transpose(1, 2)
    roughness = G.get_roughness(params)[:, 0]

    irr = irradiance_sample(sample_idx, bake, env_term, vertex_normals,
                            albedo, roughness)
    target = G.get_radiances(params)[torch.arange(n, device=xyz.device),
                                     sample_idx]
    err = (irr - target).abs()
    if alive is not None:
        return torch.where(alive[:, None], err, torch.zeros_like(err)).sum() \
            / (torch.clamp(alive.sum(), min=1) * 3)
    return err.mean()
