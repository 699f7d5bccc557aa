"""The radiance model of stage 2: the bake (hemisphere-sample every surfel,
trace the samples, store radiance, visibility, first hit and its uv), the
one-bounce irradiance at one chosen sample per surfel and the
radiance-consistency loss of the stage-2 step, and the one-bounce
irradiance at every sample (``irradiance_full``) with which the relighting
evaluation re-bakes the radiances under a new light.

Mirrors ``svgir_tpu.models.radiance`` (reference ``gaussian_model.py:
466-575`` and ``intersect_test.slang:904+, 1143-1378, 1879-1990``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models.lights import equirect_grid_coords
from svgir_tpu_torch.ops import grid_tracer, tracing
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize


def _march_extent(means, scales) -> float:
    """March range of the grid tracer: the AABB diagonal of the surfels
    plus a 3-sigma margin at each end, on the host in numpy as
    ``svgir_tpu``'s bake computes it (the reference march is unbounded)."""
    m_np = means.detach().cpu().numpy()
    margin = 3.0 * float(scales.detach().cpu().numpy().max())
    diag = float(np.linalg.norm(m_np.max(0) - m_np.min(0))) \
        if m_np.size else 1.0
    return max(diag + 2.0 * margin, 1e-3)


def bake_radiance(means: torch.Tensor, scales: torch.Tensor,
                  quats: torch.Tensor, opacity: torch.Tensor,
                  shs: torch.Tensor, *, sample_num: int = 64,
                  azimuth: Optional[torch.Tensor] = None, k_hits: int = 16,
                  ray_chunk: int = 65536,
                  use_grid: Optional[bool] = None) -> Dict:
    """Trace ``sample_num`` hemisphere samples from every surfel
    (update_radiace, gaussian_model.py:466-522) and march them.

    The spiral of each surfel turns by 2*pi*azimuth: ``azimuth`` [N, 1]
    uniform in [0, 1) (the caller draws it), or none (unturned).
    The grid tracer (``ops/grid_tracer``, its march on kernel B8) is the
    default from 4096 surfels; below that, and with ``use_grid=False``,
    the brute tracer (``tracing.nearest_hits``), which gives the same hits.
    Rays run in chunks of ``ray_chunk``; the results do not depend on it.

    Returns radiance [N, S, 3], visibility [N, S, 1], incident_dirs
    [N, S, 3], incident_areas [N, S, 1], incident_qxy [N, S, 2] (the
    equirect grid coordinates of the directions), hit_idx [N, S], uv
    [N, S, 2] and exhausted_frac (0-d: the share of rays that used all
    k_hits hits while still marching).
    """
    n = means.shape[0]
    s = sample_num
    dev = means.device
    geo = tracing.build_surfel_geometry(means, scales, quats, opacity)
    dirs, areas = fibonacci_sphere_sampling(geo.normal, s, azimuth)
    rays_o = means.repeat_interleave(s, 0)
    rays_d = dirs.reshape(-1, 3)
    self_idx = torch.arange(n, dtype=torch.int32,
                            device=dev).repeat_interleave(s)

    if use_grid is None:
        use_grid = n >= G.GRID_FROM
    if use_grid:
        grid_t_max = _march_extent(means, scales)
        grid = grid_tracer.build_grid_auto(geo,
                                           res=grid_tracer.auto_res(geo))
        n_steps = grid_tracer._concrete_n_steps(grid, grid_t_max)

    outs = []
    for r0 in range(0, n * s, ray_chunk):
        sl = slice(r0, min(r0 + ray_chunk, n * s))
        o, d = rays_o[sl], rays_d[sl]
        if use_grid:
            hits = grid_tracer.nearest_hits_grid(
                geo, grid, o, d, t_max=grid_t_max, k=k_hits, n_steps=n_steps)
        else:
            hits = tracing.nearest_hits(geo, o, d, k=k_hits)
        outs.append(tracing.radiance_march(hits, self_idx[sl], shs, means, o))
    cat = {k: torch.cat([x[k] for x in outs], 0) for k in outs[0]}
    qx, qy = equirect_grid_coords(dirs)
    return {
        "radiance": cat["radiance"].reshape(n, s, 3),
        "visibility": cat["visibility"].reshape(n, s, 1),
        "incident_dirs": dirs,
        "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": cat["first_hit"].reshape(n, s),
        "uv": cat["first_uv"].reshape(n, s, 2),
        "exhausted_frac": cat["exhausted"].to(torch.float32).mean(),
    }


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


IRRADIANCE_BUDGET = 4 << 30   # bytes of temporaries per irradiance_full chunk


def irradiance_full(bake: Dict, env_term: torch.Tensor,
                    vertex_normals: torch.Tensor, vertex_albedo: torch.Tensor,
                    roughness: torch.Tensor) -> torch.Tensor:
    """One-bounce irradiance at every primary sample [N, S, 3] (the Slang
    ``render_irradiance``, calculate_radiance at gaussian_model.py:530-542):
    ``irradiance_sample`` for each sample index.

    The [N, 9S+25] table is built once.  Only the (surfel, sample) pairs
    whose ray hit a surfel are shaded (the others are 0, as the reference's
    ``where`` makes them), in chunks of pairs sized so that a chunk's table
    rows and shading temporaries ([pairs, S, 4, 3] and its kin) stay near
    IRRADIANCE_BUDGET; each pair's value is independent of the others, so
    the chunking changes no value."""
    n, s = bake["hit_idx"].shape
    table = _hit_table(bake, env_term, vertex_normals, vertex_albedo,
                       roughness)
    hit = bake["hit_idx"].reshape(-1)
    dirs = bake["incident_dirs"].reshape(-1, 3)
    out = table.new_zeros(n * s, 3)
    pairs = torch.nonzero(hit >= 0)[:, 0]
    step = max(IRRADIANCE_BUDGET // (4 * (9 * s + 25 + 96 * s)), 1)
    for p0 in range(0, pairs.shape[0], step):
        p = pairs[p0:p0 + step]
        out[p] = _irradiance_from_table(table, dirs[p], hit[p], s)
    return out.reshape(n, s, 3)
