"""Ray tracing over Gaussian surfels: the per-surfel geometry, the surfel
hit test, the brute-force K-nearest-hit tracer and the radiance march that
replays the sampling-SH march over a ray's sorted hits.

Mirrors ``svgir_tpu.ops.tracing`` (reference ``intersect_test.slang:
94-150, 356-424, 1879-1990``).  ``nearest_hits`` is the bake's tracer for
small scenes and the oracle of the grid march (``ops/grid_tracer.py``).
``trace_visibility`` is the brute-force visibility tracer of
``finetune_visibility`` (trace.cu:196-280): a masked product of
(1 - alpha) over all (ray, surfel) pairs at each pair's max-density point.

Order of evaluation.  For thin surfels (z scale ~0, inverse covariance up
to 1e12) the hit test's power ``-0.5 p^T Sigma^-1 p`` cancels
catastrophically: its value is float32 rounding noise of magnitude up to
hundreds, and which hits pass the alpha gate depends on the exact order
of every product and sum (ROADMAP C-1).  Every tracer of this package
evaluates the test through ``surfel_test`` below, one operation at a time
in ``grid_tracer._test_candidates``' order, with explicit three-term sums
(no reductions, no ``einsum``), so the brute tracer, the grid march's
plain version and the CUDA march kernel (``csrc/march.cu``, which rounds
each operation the same way) agree hit for hit.  XLA on the CPU contracts
multiply-adds into fused multiply-adds, so on thin surfels the JAX package
accepts other hits than this one; on well-conditioned surfels the two
agree.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from svgir_tpu_torch.ops.common import ALPHA_MAX, ALPHA_MIN
from svgir_tpu_torch.utils import sh as sh_utils
from svgir_tpu_torch.utils.transforms import normalize, quat_to_rotmat

__all__ = ["ALPHA_MIN", "ALPHA_MAX", "SurfelGeometry",
           "build_surfel_geometry", "surfel_test", "nearest_hits",
           "radiance_march", "trace_visibility"]


class SurfelGeometry(NamedTuple):
    """Per-surfel quantities of every tracer (computed once per bake)."""

    means: torch.Tensor     # [N, 3]
    inv_cov: torch.Tensor   # [N, 6] inverse covariance (xx,xy,xz,yy,yz,zz)
    opacity: torch.Tensor   # [N]
    normal: torch.Tensor    # [N, 3] geometric normal (R[:, :, 2])
    rot: torch.Tensor       # [N, 3, 3]
    scales: torch.Tensor    # [N, 3]
    valid: torch.Tensor     # [N] bool


def build_surfel_geometry(means, scales, quats, opacity, valid=None,
                          max_inv_scale: float = 1e6) -> SurfelGeometry:
    """Inverse covariance R diag(1/s^2) R^T (gaussian_model.py:379-382).

    1/s is clamped at ``max_inv_scale`` (flat surfels store a z scale of
    ~0) so the intersection math stays finite."""
    R = quat_to_rotmat(quats)
    inv_s = torch.clamp(1.0 / torch.clamp(scales, min=1e-12),
                        max=max_inv_scale)
    M = R * inv_s[:, None, :]

    def s(i, j):          # (M M^T)_ij, summed left to right
        return M[:, i, 0] * M[:, j, 0] + M[:, i, 1] * M[:, j, 1] \
            + M[:, i, 2] * M[:, j, 2]
    inv_cov = torch.stack([s(0, 0), s(0, 1), s(0, 2), s(1, 1), s(1, 2),
                           s(2, 2)], -1)
    if valid is None:
        valid = torch.ones(means.shape[0], dtype=torch.bool,
                           device=means.device)
    return SurfelGeometry(means=means, inv_cov=inv_cov, opacity=opacity,
                          normal=R[:, :, 2], rot=R, scales=scales,
                          valid=valid.to(torch.bool))


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def surfel_test(means, normal, rot, scales, inv_cov, opacity, rays_o,
                rays_d):
    """The surfel hit test of ``_test_candidates`` / ``_ellipse_uv`` for
    (ray, surfel) pairs that broadcast: surfel fields [..., G, F] against
    rays [R, 1, 3].

    Returns (t_plane, dis, power, alpha, facing, u, v), each [R, G]: the
    plane-hit distance, the ellipse metric u^2+v^2 in units of the scales,
    the power at the plane hit, min(0.99, opacity*exp(power)), whether the
    ray meets the front face, and the local (u, v) before the swap."""
    d = rays_d
    denom_raw = _dot3(normal, d)
    denom = torch.where(denom_raw.abs() < 1e-6,
                        torch.full_like(denom_raw, 1e-6), denom_raw)
    t_plane = _dot3(means - rays_o, normal) / denom
    tp = t_plane[..., None]
    p = (rays_o + tp * d) - means                 # plane hit - mean
    # local_j = sum_i rot[i, j] p_i (rot row-major)
    lu = rot[..., 0, 0] * p[..., 0] + rot[..., 1, 0] * p[..., 1] \
        + rot[..., 2, 0] * p[..., 2]
    lv = rot[..., 0, 1] * p[..., 0] + rot[..., 1, 1] * p[..., 1] \
        + rot[..., 2, 1] * p[..., 2]
    u = lu / torch.clamp(scales[..., 0], min=1e-12)
    v = lv / torch.clamp(scales[..., 1], min=1e-12)
    dis = u * u + v * v
    pd = (means - rays_o) - tp * d                # mean - plane hit
    px, py, pz = pd[..., 0], pd[..., 1], pd[..., 2]
    ic = inv_cov
    power = -0.5 * (ic[..., 0] * px * px + ic[..., 3] * py * py
                    + ic[..., 5] * pz * pz
                    + 2 * (ic[..., 1] * px * py + ic[..., 2] * px * pz
                           + ic[..., 4] * py * pz))
    alpha = torch.clamp(opacity * torch.exp(power), max=ALPHA_MAX)
    return t_plane, dis, power, alpha, denom_raw < 0.0, u, v


def swapped_uv(u, v):
    """The hit's uv with the reference's u < v swap (intersect_test.slang:
    94-150), each clamped to [0.001, 0.999] -> [..., 2]."""
    swap = u < v
    u2, v2 = torch.where(swap, v, u), torch.where(swap, u, v)
    return torch.stack([torch.clamp(u2 * 0.5 + 0.5, 0.001, 0.999),
                        torch.clamp(v2 * 0.5 + 0.5, 0.001, 0.999)], -1)


def accepted(valid, dis, power, alpha, facing):
    """The leaf acceptance of gs_bvh_hit (intersect_test.slang:356-412):
    inside the 3-sigma ellipse, power <= 0, alpha >= 1/255, front-facing."""
    return (valid & (dis <= 9.0) & (power <= 0) & (alpha >= ALPHA_MIN)
            & facing)


def topk_smallest(t, idx, k: int):
    """The k smallest of t [R, W] in ascending order with their idx; ties
    keep their column order (``lax.top_k`` on -t)."""
    ts, order = torch.sort(t, dim=1, stable=True)
    return ts[:, :k], torch.gather(idx, 1, order[:, :k])


def nearest_hits(geo: SurfelGeometry, rays_o: torch.Tensor,
                 rays_d: torch.Tensor,
                 self_index: Optional[torch.Tensor] = None, *,
                 chunk: int = 512, k: int = 16) -> Dict:
    """K nearest accepted hits per ray, sorted by t (brute force over the
    surfels in chunks).  Acceptance as ``accepted`` plus t > 0; t_min
    filtering is left to the march.  Returns t [R, k] (inf = none), idx
    [R, k], alpha [R, k], uv [R, k, 2]."""
    n = geo.means.shape[0]
    r = rays_o.shape[0]
    dev = rays_o.device
    hits = {"t": torch.full((r, k), float("inf"), device=dev),
            "idx": torch.full((r, k), -1, dtype=torch.int32, device=dev),
            "alpha": torch.zeros(r, k, device=dev),
            "uv": torch.zeros(r, k, 2, device=dev)}
    o, d = rays_o[:, None], rays_d[:, None]
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        t_plane, dis, power, alpha, facing, u, v = surfel_test(
            geo.means[sl], geo.normal[sl], geo.rot[sl], geo.scales[sl],
            geo.inv_cov[sl], geo.opacity[sl], o, d)
        ok = accepted(geo.valid[sl], dis, power, alpha, facing) \
            & (t_plane > 0)
        gidx = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                            device=dev)[None].expand(r, -1)
        if self_index is not None:
            ok = ok & (gidx != self_index[:, None])
        t_cand = torch.where(ok, t_plane, torch.full_like(t_plane,
                                                          float("inf")))
        all_t = torch.cat([hits["t"], t_cand], 1)
        ts, order = torch.sort(all_t, dim=1, stable=True)
        sel = order[:, :k]
        hits = {
            "t": ts[:, :k],
            "idx": torch.gather(torch.cat([hits["idx"], gidx], 1), 1, sel),
            "alpha": torch.gather(torch.cat([hits["alpha"], alpha], 1), 1,
                                  sel),
            "uv": torch.gather(torch.cat([hits["uv"], swapped_uv(u, v)], 1),
                               1, sel[..., None].expand(-1, -1, 2)),
        }
    return hits


def _pair_terms(geo: SurfelGeometry, rays_o, rays_d, sl):
    """Per (ray, surfel of the slice ``sl``) terms [R, G] of the visibility
    tracer: t of the max-density point along the ray, the power (log
    density) there and alpha = opacity * exp(power).  Each sum and product
    in the reference's order (tracing.py's ``_pair_terms``)."""
    mu = geo.means[sl]
    ic = geo.inv_cov[sl]
    d = rays_d
    mo = mu[None] - rays_o[:, None]                          # [R, G, 3]
    qx = ic[:, 0] * mo[..., 0] + ic[:, 1] * mo[..., 1] + ic[:, 2] * mo[..., 2]
    qy = ic[:, 1] * mo[..., 0] + ic[:, 3] * mo[..., 1] + ic[:, 4] * mo[..., 2]
    qz = ic[:, 2] * mo[..., 0] + ic[:, 4] * mo[..., 1] + ic[:, 5] * mo[..., 2]
    t1 = qx * d[:, None, 0] + qy * d[:, None, 1] + qz * d[:, None, 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    t2 = (ic[None, :, 0] * dx * dx + ic[None, :, 3] * dy * dy
          + ic[None, :, 5] * dz * dz
          + 2 * (ic[None, :, 1] * dx * dy + ic[None, :, 2] * dx * dz
                 + ic[None, :, 4] * dy * dz))
    t = t1 / torch.where(t2 == 0, torch.full_like(t2, 1e-12), t2)
    hx = mo[..., 0] - t * dx
    hy = mo[..., 1] - t * dy
    hz = mo[..., 2] - t * dz
    power = -0.5 * (ic[None, :, 0] * hx * hx + ic[None, :, 3] * hy * hy
                    + ic[None, :, 5] * hz * hz
                    + 2 * (ic[None, :, 1] * hx * hy + ic[None, :, 2] * hx * hz
                           + ic[None, :, 4] * hy * hz))
    alpha = geo.opacity[sl][None] * torch.exp(power)
    return t, power, alpha


def trace_visibility(geo: SurfelGeometry, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, *, chunk: int = 512) -> Dict:
    """Opacity along rays [R, 3] (callers offset the origins by 0.05 d,
    bvh/__init__.py:59), over the surfels in chunks of ``chunk``.  A pair
    counts where the surfel is valid with opacity >= 1/255, the ray does
    not meet its back (n . d <= 0), and at the max-density point t >= 0.01
    and power <= 0; there is no ellipse test.  T = exp(sum log(1 -
    min(alpha, 0.99))), set to 0 below 0.9.  Returns visibility [R, 1] and
    contribute [R, 1] (the count of pairs)."""
    n = geo.means.shape[0]
    r = rays_o.shape[0]
    dev = rays_o.device
    log_t = torch.zeros(r, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        t, power, alpha = _pair_terms(geo, rays_o, rays_d, sl)
        ok = (geo.valid[sl][None] & (geo.opacity[sl][None] >= ALPHA_MIN)
              & (_dot3(geo.normal[sl][None], rays_d[:, None]) <= 0)
              & (t >= 0.01) & (power <= 0))
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        log_t = log_t + torch.log1p(-torch.clamp(a, max=ALPHA_MAX)).sum(1)
        count = count + ok.sum(1, dtype=torch.int32)
    vis = torch.exp(log_t)
    vis = torch.where(vis < 0.9, torch.zeros_like(vis), vis)
    return {"visibility": vis[:, None], "contribute": count[:, None]}


def radiance_march(hits: Dict, self_index: torch.Tensor, shs: torch.Tensor,
                   means: torch.Tensor, rays_o: torch.Tensor, *,
                   t_min_first: float = 0.042, t_min_next: float = 0.01,
                   t_window: float = 0.2) -> Dict:
    """Replay the sampling-SH march over the sorted hits
    (intersect_test.slang:1928-1978): sliding window (first [0.042, 0.2],
    then [t + 0.01, t + 0.2] from each accepted hit), composite
    ``eval_sh(hit, dir to hit centre) + 0.5`` times alpha*T; stop at a
    window gap, at the source surfel, or when T <= 0.001; not visible once
    T < 0.2.  Returns radiance [R, 3] (clamped to [0, 10]), visibility
    [R, 1], first_hit [R], first_uv [R, 2], exhausted [R] (all K hits used
    while still marching)."""
    r, k = hits["t"].shape
    dev = rays_o.device
    t_prev = torch.zeros(r, device=dev)
    T = torch.ones(r, device=dev)
    sh_acc = torch.zeros(r, 3, device=dev)
    first = torch.full((r,), -1, dtype=torch.int32, device=dev)
    first_uv = torch.zeros(r, 2, device=dev)
    done = torch.zeros(r, dtype=torch.bool, device=dev)
    visible = torch.ones(r, dtype=torch.bool, device=dev)
    for i in range(k):
        t_i = hits["t"][:, i]
        idx_i = hits["idx"][:, i]
        fresh = first < 0
        lo = torch.where(fresh, torch.full_like(t_prev, t_min_first),
                         t_prev + t_min_next)
        hi = torch.where(fresh, torch.full_like(t_prev, t_window),
                         t_prev + t_window)
        skip = t_i < lo
        in_win = (t_i >= lo) & (t_i <= hi) & torch.isfinite(t_i)
        gap = ~skip & ~in_win
        is_self = in_win & (idx_i == self_index)
        accept = in_win & ~is_self & ~done
        done = done | ((gap | is_self) & ~done)

        h = torch.clamp(idx_i, 0, means.shape[0] - 1).long()
        sh_dir = normalize(means[h] - rays_o)
        c = sh_utils.eval_sh(3, shs[h].transpose(-1, -2), sh_dir) + 0.5
        alpha_i = hits["alpha"][:, i]
        sh_acc = sh_acc + torch.where(accept[:, None],
                                      c * (alpha_i * T)[:, None],
                                      torch.zeros_like(c))
        new_T = torch.where(accept, T * (1 - alpha_i), T)
        visible = visible & ~(accept & (new_T < 0.2))
        take = accept & fresh
        first = torch.where(take, idx_i, first)
        first_uv = torch.where(take[:, None], hits["uv"][:, i], first_uv)
        t_prev = torch.where(accept, t_i, t_prev)
        done = done | (new_T <= 0.001)
        T = new_T
    exhausted = ~done & torch.isfinite(hits["t"][:, k - 1])
    vis = torch.where(visible, T, torch.zeros_like(T))
    return {"radiance": torch.clamp(sh_acc, 0.0, 10.0),
            "visibility": vis[:, None],
            "first_hit": first, "first_uv": first_uv, "exhausted": exhausted}
