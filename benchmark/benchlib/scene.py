"""The cell's inputs, made on the device from ``--seed``: the surfels of a
trained stage-1 model, the training views with their procedural ground
truth, and for stage 2 the env map and a radiance bake laid out as the
program's compact bake lays it out.

Every draw comes from one ``torch.Generator`` on the device, in a few large
calls, so the same seed gives the same inputs and a run makes them in well
under a second.  Both the program and the reference are handed these
tensors (or, after the window, the same tensors made again from the seed).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from reference.models import gaussians as G
from reference.models.lights import equirect_grid_coords
from reference.utils.graphics import fibonacci_sphere_sampling
from reference.utils.sh import rgb_to_sh
from reference.utils.transforms import (inverse_sigmoid, normal_to_rotation,
                                        normalize)

SH_COEFFS = 16          # SH degree 3


@dataclass
class View:
    """One training view: the pose as the camera constructors take it,
    and its ground truth on the device."""

    eye: np.ndarray
    fov: float
    width: int
    height: int
    image: torch.Tensor          # [3, H, W]
    mask: torch.Tensor           # [1, H, W]


def generator(seed: int, stream: int, dev) -> torch.Generator:
    """A device generator for one part of the inputs (surfels, views, env,
    bake), so that each part draws the same numbers whatever the others
    draw.  ``seed`` may be any whole number below 2**62."""
    return torch.Generator(device=dev).manual_seed(
        (int(seed) * 8 + stream) % (1 << 63))


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``v`` (int64) two zeros apart."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """Row order of ``xyz`` [N, 3] along a 30-bit Morton curve over its
    bounding box (the spatial order a trained model's rows keep)."""
    lo = xyz.min(0).values
    span = torch.clamp(xyz.max(0).values - lo, min=1e-12)
    q = torch.clamp((xyz - lo) / span * 1024.0, 0, 1023).long()
    code = (_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1) \
        | _spread_bits(q[:, 2])
    return torch.argsort(code, stable=True)


def make_surfels(cfg: Dict, seed: int, dev) -> Dict:
    """Stage-1 parameters of ``cfg["alive"]`` surfels in ``cfg["rows"]``
    rows: a shell of surfels (``bench.py``'s ball) facing outward, in
    Morton order over a random subset of the rows; dead rows hold zeros
    and opacity logit -10.  Returns {"params", "alive", "rows"} (the alive
    rows, ascending)."""
    sc = cfg["scene"]
    n, cap = cfg["alive"], cfg["rows"]
    g = generator(seed, 0, dev)
    u = torch.rand(n, 8, generator=g, device=dev)
    dirs = normalize(torch.randn(n, 3, generator=g, device=dev))
    r_lo, r_hi = sc["shell_radius"]
    xyz = dirs * (r_lo + (r_hi - r_lo) * u[:, :1])
    order = morton_order(xyz)
    xyz, dirs, u = xyz[order], dirs[order], u[order]
    tilt = sc["normal_tilt"] * torch.randn(n, 3, generator=g, device=dev)
    normals = normalize(dirs + tilt)
    s_lo, s_hi = (math.log(x) for x in sc["scale"])
    log_s = s_lo + (s_hi - s_lo) * u[:, 1:3]
    o_lo, o_hi = sc["opacity"]
    opac = inverse_sigmoid(o_lo + (o_hi - o_lo) * u[:, 3:4])
    rgb = 0.1 + 0.8 * u[:, 4:7]
    rest = sc["sh_rest_std"] * torch.randn(n, SH_COEFFS - 1, 3, generator=g,
                                           device=dev)
    rows = torch.sort(torch.randperm(cap, generator=g, device=dev)[:n]).values

    def place(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=dev)
        out[rows] = x
        return out

    params = {
        "xyz": place(xyz),
        "normal": place(normals),
        "shs_dc": place(rgb_to_sh(rgb)[:, None]),
        "shs_rest": place(rest),
        "scaling": place(torch.cat([log_s, log_s[:, :1]], -1)),
        "rotation": place(normal_to_rotation(normals)),
        "opacity": place(opac, fill=-10.0),
    }
    alive = torch.zeros(cap, dtype=torch.bool, device=dev)
    alive[rows] = True
    return {"params": params, "alive": alive, "rows": rows}


def view_eyes(cfg: Dict, seed: int) -> np.ndarray:
    """[V, 3] camera centres: a Fibonacci spiral over the band of
    elevations ``views.elevation_deg`` at ``views.distance``, turned about
    the vertical by an angle drawn from the seed."""
    vc = cfg["views"]
    n = vc["count"]
    e_lo, e_hi = (math.radians(x) for x in vc["elevation_deg"])
    turn = np.random.default_rng(int(seed) % (1 << 63)).uniform(0, 2 * np.pi)
    i = np.arange(n) + 0.5
    z = math.sin(e_lo) + (math.sin(e_hi) - math.sin(e_lo)) * i / n
    phi = turn + i * math.pi * (3.0 - math.sqrt(5.0))
    rad = np.sqrt(1.0 - z * z)
    return vc["distance"] * np.stack([rad * np.cos(phi), rad * np.sin(phi),
                                      z], -1)


def camera_axes(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation [right, down, forward] (columns) of a
    camera at ``eye`` looking at the origin with +z up, as the camera
    constructors form it."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)


def make_views(cfg: Dict, seed: int, dev) -> List[View]:
    """The training views and their ground truth: inside the silhouette of
    a sphere of radius ``views.object_radius`` a smooth colour field of the
    sphere's normal (frequencies and phases from the seed), black outside;
    the mask is the silhouette."""
    vc = cfg["views"]
    res, fov = cfg["resolution"], vc["fov"]
    g = generator(seed, 1, dev)
    freq = 1.0 + 3.0 * torch.rand(3, 3, generator=g, device=dev)
    phase = 2 * math.pi * torch.rand(3, generator=g, device=dev)
    focal = res / (2 * math.tan(fov / 2))
    ax = torch.arange(res, dtype=torch.float32, device=dev)
    v, uu = torch.meshgrid(ax, ax, indexing="ij")
    cam_dirs = torch.stack([(uu - res / 2) / focal, (v - res / 2) / focal,
                            torch.ones_like(uu)], -1).reshape(-1, 3)
    radius = vc["object_radius"]
    views = []
    for eye in view_eyes(cfg, seed):
        rot = torch.as_tensor(camera_axes(eye), dtype=torch.float32,
                              device=dev)
        o = torch.as_tensor(eye, dtype=torch.float32, device=dev)
        d = normalize(cam_dirs @ rot.T)
        b = (d * o).sum(-1)
        disc = b * b - (o * o).sum() + radius * radius
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        nrm = (o + t[:, None] * d) / radius
        col = 0.5 + 0.4 * torch.sin(nrm @ freq.T + phase)
        img = torch.where(hit[:, None], col, torch.zeros_like(col))
        views.append(View(eye=eye, fov=fov, width=res, height=res,
                          image=img.T.reshape(3, res, res).contiguous(),
                          mask=hit.float().reshape(1, res, res)))
    return views


def cameras_extent(eyes: np.ndarray) -> float:
    """The scene readers' extent (getNerfppNorm): 1.1 times the largest
    distance of a camera centre from their mean."""
    centre = eyes.mean(0)
    return float(np.linalg.norm(eyes - centre, axis=1).max() * 1.1)


def make_env(cfg: Dict, seed: int, light_init: float, dev) -> torch.Tensor:
    """The learnable env map's initial value: ``light_init`` x U[0, 1) of
    shape [H, 2H, 3], as the stage-2 trainer initializes it."""
    h = cfg["env_resolution"]
    g = generator(seed, 2, dev)
    return light_init * torch.rand(h, 2 * h, 3, generator=g, device=dev)


def make_bake(cfg: Dict, traffic: Dict, surfels: Dict, seed: int,
              dev) -> Dict:
    """A stage-2 radiance bake of every row, laid out as the program's
    compact bake (``trainer.bake_radiance_compact``) lays out its own.

    Alive rows: ``sample_num`` Fibonacci directions around the surfel's
    normal (the third column of its rotation), the spiral turned by a
    drawn azimuth.  Of the ``traffic["bake"]`` shares: a share
    ``alive_rows_all_miss_share`` of the alive rows misses with every ray,
    and the other rows' rays miss so that a share ``alive_miss_share`` of
    all alive rays misses (hit -1, visibility 1, radiance and uv 0); the
    rest hit an alive row drawn uniformly, with visibility 0 for a share
    ``hit_blocked_share`` of them and else uniform in ``hit_visibility``
    (the march keeps 0 or [0.2, 1)), a radiance in [0, 1) and a uv in
    [0, 1).  Dead rows: direction 0 (so their equirect coordinates all
    fall on one texel), area 2*pi, hit -1, visibility 1, radiance and uv
    0."""
    bc = traffic["bake"]
    s = cfg["sample_num"]
    cap = cfg["rows"]
    rows = surfels["rows"]
    n = rows.shape[0]
    g = generator(seed, 3, dev)
    azimuth = torch.rand(n, 1, generator=g, device=dev)
    # the surfel's normal as its rotation gives it, as the bake takes it
    normals = G.get_geo_normal(
        {"rotation": surfels["params"]["rotation"][rows]})
    dirs_a, areas_a = fibonacci_sphere_sampling(normals, s, azimuth)
    u = torch.rand(n, s, 7, generator=g, device=dev)
    all_miss = bc["alive_rows_all_miss_share"]
    ray_miss = (bc["alive_miss_share"] - all_miss) / max(1.0 - all_miss,
                                                         1e-12)
    row_u = torch.rand(n, 1, generator=g, device=dev)
    hit = (row_u >= all_miss) & (u[..., 0] >= ray_miss)
    target = rows[torch.randint(0, n, (n, s), generator=g, device=dev)]
    blocked = u[..., 1] < bc["hit_blocked_share"]
    v_lo, v_hi = bc["hit_visibility"]
    vis_hit = torch.where(blocked, torch.zeros_like(u[..., 2]),
                          v_lo + (v_hi - v_lo) * u[..., 2])
    hf = hit[..., None].float()

    def place(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=dev)
        out[rows] = x
        return out

    dirs = place(dirs_a)
    qx, qy = equirect_grid_coords(dirs)
    return {
        "radiance": place(u[..., 3:6] * hf),
        "visibility": place(torch.where(hit, vis_hit,
                                        torch.ones_like(vis_hit))[..., None],
                            fill=1.0),
        "incident_dirs": dirs,
        "incident_areas": place(areas_a, fill=2.0 * math.pi),
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": place(torch.where(hit, target.to(torch.int32),
                                     torch.full_like(target, -1,
                                                     dtype=torch.int32)),
                         fill=-1),
        "uv": place(torch.stack([u[..., 6], u[..., 2]], -1) * hf),
    }
