#!/usr/bin/env python3
"""Smoke run of svgir_tpu_torch on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py            # all phases, from the repository root
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler
                                          # table of one train step to DIR

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build    compile csrc/*.cu with nvcc (in parallel) and load them;
              print the card's name and power limit.
  2. render   the bench scene (800x800 camera, 50,000 surfels on a ball
              shell, rotation_init="normal", OptimizationConfig defaults;
              data from a seeded torch.Generator) rendered forward only
              (render_view_stage1, the eval path) at the default instance
              cap; launch counts reset just before and read just after.
              Its padded instance count sizes the cap of the later phases
              as bench.py does (x1.05, rounded up to 2048).
  3. train    five steps of train_stage1 on the bench scene; loss, Adam
              moments and parameters finite, no binner overflow; launch
              counts reset just before and read just after.
  4. kernels  each kernel against its plain PyTorch version on the card, on
              the exact inputs the train step gives it (captured from one
              step of the bench scene), plus a vertex-channel case (CV > 0,
              multi-chunk tiles, weight-sum cotangent present) on a smaller
              scene.  B1/B2 must be equal integer for integer; B3/B4 within
              the tolerances below.
  5. parity   the small scene rendered forward and backward on the card
              (kernels) and on the CPU (plain versions): image and
              gradients agree.
  6. timing   median times of the render and the train step (at the snug
              and at the default cap), of each kernel, its plain version
              and, for B1, a bincount + cumsum yardstick.
  Stage 2 (the deferred-PBR mode, bench_stage2.py's configuration: the
  bench scene upgrade_to_pbr'd, a synthetic radiance bake with S = 24
  incident samples per surfel made from a seeded generator, a 32x64 env):
  7. s2 render   render_view_svgss(is_training=False) at the snug cap:
                 finite images, no overflow; B7 forward and B3 launched.
  8. s2 train    five steps of make_svgss_train_step: finite loss, moments
                 and parameters (env included), a nonzero env gradient, no
                 overflow; B7 forward and backward, B3 and B4 launched at
                 least once per step.
  9. s2 kernels  B7 forward/backward and B3/B4 at CA 13 / CV 13 against
                 their plain versions on the inputs of one stage-2 step,
                 B3 at CA 16 / CV 16 on the eval render's inputs.
  10. s2 parity  a small stage-2 scene rendered and stepped on the card and
                 on the CPU: images, loss and gradients agree.
  11. s2 timing  stage-2 train step and eval render medians; B7 with its
                 plain version, bound and grid_sample yardstick; B3/B4 at
                 stage-2 width.

The second-to-last line of output is the kernels JSON; before it the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# B3/B4 tolerances (kernel vs plain, same inputs, same device).  The kernel
# sums in another order (sequential per pixel, shuffle trees over pixels),
# so channel sums and row reductions differ by float32 rounding; the
# reconstructed transmittance of saturated pixels may cross the 1e-4 gate
# at another instance (ROADMAP C-7), so logT is held to 1e-4 there.
TOL_IMG = 1e-4          # absolute, plus 1e-4 relative, on channel sums
TOL_LOGT_SAT = 1e-4     # absolute, saturated pixels
TOL_ROWS = 1e-3         # of each row kind's largest magnitude (d_slab)

# B7 tolerances: the forward rounds every product and sum as the plain
# version does (exact in principle, 1e-6 absolute allowed); the backward
# sums each block's queries with shared-memory atomics in a varying order.
TOL_ENV_FWD = 1e-6      # absolute
TOL_ENV_BWD = 1e-5      # of the largest |d_env|
# Stage-2 parity, card vs CPU: the vertex channels are divided by the
# opacity and pass through sRGB, which amplifies float32 rounding
# (tests/test_torch_svgss.py); gradients as the CPU tests hold them.
TOL_S2_IMG = 2e-4       # absolute; direct/indirect twice that
TOL_S2_DEPTH = 5e-4     # relative
TOL_S2_GRAD = 2.5e-3    # of each gradient's largest magnitude

STAGE1_KERNELS = ("binning_counts", "binning_instances", "blend_forward",
                  "blend_backward")

HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_S = 67e12      # H100 SXM float32 (and integer ALU) rate, non-tensor


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps=10, warmup=2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(fn, reps=10, warmup=2) -> float:
    """Median wall time of fn() in ms, each call ended by a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bench_scene(device, n=50_000, res=800, seed=0):
    """The scene of bench.py, with its random draws from torch."""
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator(device=device).manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g, device=device))
    r = 0.7 + 0.3 * torch.rand(n, 1, generator=g, device=device)
    cols = torch.rand(n, 3, generator=g, device=device)
    gt = torch.rand(3, res, res, generator=g, device=device)
    state = G.init_from_points(dirs * r, cols, normals=dirs, capacity=n,
                               rotation_init="normal", device=device)
    cam = look_at_camera(eye=[0.5, 0.4, -2.6], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device=device)
    import dataclasses
    cam = dataclasses.replace(cam, image=gt,
                              image_mask=torch.ones(1, res, res,
                                                    device=device))
    return state, cam


def small_scene(device, n=6000, res=128, seed=1):
    """Surfels facing a close camera, with 3 plain features and 8 vertex
    features (CV = 2): tiles hold several chunks and saturate."""
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize

    g = torch.Generator().manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g))
    sc = dict(means=dirs.clone(), quats=normal_to_rotation(dirs),
              scales=torch.exp(torch.randn(n, 3, generator=g) * 0.3) * 0.12,
              opacity=0.2 + 0.6 * torch.rand(n, generator=g),
              colors=torch.rand(n, 3, generator=g),
              features=torch.rand(n, 3, generator=g),
              vfeatures=torch.rand(n, 8, generator=g))
    sc = {k: v.to(device) for k, v in sc.items()}
    cam = look_at_camera(eye=[0.3, 0.2, -1.8], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device=device)
    return sc, cam


class Capture:
    """Records the arguments of the first call of each kernel entry point
    (ops functions looked up at call time)."""

    def __init__(self):
        from svgir_tpu_torch.ops import (binning, blend_pallas_strip,
                                         env_lookup_pallas)
        self.targets = [(binning, "compute_counts"),
                        (binning, "compute_instances"),
                        (blend_pallas_strip, "blend_forward"),
                        (blend_pallas_strip, "blend_backward"),
                        (env_lookup_pallas, "env_lookup_forward"),
                        (env_lookup_pallas, "env_lookup_backward")]
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def rec(*a, _fn=fn, _name=name, **kw):
                self.calls.setdefault(_name, (a, kw))
                return _fn(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def loss_small(bufs, tgt):
    return ((bufs.color - tgt).abs().mean() + bufs.depth.mean()
            + 0.3 * bufs.normal.sum() + 0.2 * bufs.feature.sum()
            + 0.1 * bufs.vfeature.sum() + 0.05 * bufs.opacity.mean()
            + 1e-3 * bufs.weights.sum())


def run_small(sc, cam, device):
    """Forward + backward of the small scene; returns (bufs, grads)."""
    import torch

    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.ops.rasterizer import rasterize

    cfg = RasterConfig(max_instances=1 << 18)
    args = {k: v.detach().clone().requires_grad_(True) for k, v in sc.items()}
    bg = torch.tensor([0.2, 0.1, 0.4], device=device)
    tgt = torch.rand(3, cam.height, cam.width,
                     generator=torch.Generator().manual_seed(5)).to(device)
    bufs = rasterize(args["means"], args["scales"], args["quats"],
                     args["opacity"], cam, bg, colors=args["colors"],
                     features=args["features"], vfeatures=args["vfeatures"],
                     cfg=cfg)
    grads = torch.autograd.grad(loss_small(bufs, tgt), list(args.values()))
    return bufs, dict(zip(args, grads))


def max_err_rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def compare_binning(calls):
    """B1, B2 kernel vs plain on the captured inputs: integer equality."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    from svgir_tpu_torch.ops import binning_pallas as P

    a, kw = calls["compute_counts"]
    kk = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"],
              gauss_chunk=kw.get("gauss_chunk", 256))
    kc, kcar = K.counts(*a, **kk)
    pc, pcar = P.counts_plain(*a, **kk)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(kcar, pcar)):
        raise AssertionError("B1 counts kernel disagrees with its plain "
                             "version")
    a2, kw2 = calls["compute_instances"]
    ks, kg = K.instances(*a2, **kw2)
    ps, pg = P.instances_plain(*a2, **kw2)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ps) and torch.equal(kg, pg)):
        bad = int((ks != ps).sum() + (kg != pg).sum())
        raise AssertionError(f"B2 instances kernel disagrees with its plain "
                             f"version at {bad} entries")


def compare_blend(calls, label):
    """B3, B4 kernel vs plain on the captured inputs; returns max errors.
    (The captured logT image is a saved autograd output: no_grad keeps the
    plain versions from recording a graph on it.)"""
    import torch

    with torch.no_grad():
        return _compare_blend(calls, label)


def _compare_blend(calls, label):
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas_strip as P
    from svgir_tpu_torch.ops.common import LOG_T_EPS

    a, kw = calls["blend_forward"]
    ki, ke, kwsum = K.blend_forward(*a, **kw)
    pi, pe, pwsum = P.blend_forward_plain(*a, **kw)
    torch.cuda.synchronize()
    ca, cv = kw["ca"], kw["cv"]
    if not torch.equal(ke, pe):
        raise AssertionError(f"B3 [{label}] eff differs: "
                             f"{int((ke != pe).sum())} tiles")
    nch = ca + cv
    err_img = float((ki[:nch] - pi[:nch]).abs().max()) if nch else 0.0
    lim = TOL_IMG * (1 + pi[:nch].abs())
    if not bool(((ki[:nch] - pi[:nch]).abs() <= lim).all()):
        raise AssertionError(f"B3 [{label}] channel sums differ by {err_img}")
    lt_k, lt_p = ki[nch], pi[nch]
    sat = lt_p < LOG_T_EPS
    err_lt = float((lt_k - lt_p).abs().max())
    if bool((lt_k - lt_p)[~sat].abs().max() > 1e-5) or \
            (bool(sat.any()) and
             bool((lt_k - lt_p)[sat].abs().max() > TOL_LOGT_SAT)):
        raise AssertionError(f"B3 [{label}] logT differs by {err_lt}")
    nc_bad = int((ki[nch + 1] != pi[nch + 1]).sum())
    if nc_bad > ki[nch + 1].numel() // 10000:
        raise AssertionError(f"B3 [{label}] n_contrib differs at {nc_bad} "
                             "pixels")
    err_w = 0.0
    if kwsum is not None:
        err_w = max_err_rel(kwsum, pwsum)
        if err_w > TOL_ROWS:
            raise AssertionError(f"B3 [{label}] weight sums differ: {err_w}")
    err3 = max(err_img, err_lt, err_w)
    if "blend_backward" not in calls:            # a forward-only render
        log(f"[kernels] {label}: B3 max|err| img {err_img:.3g} logT "
            f"{err_lt:.3g}; n_contrib mismatches {nc_bad}")
        return err3, None

    b, bkw = calls["blend_backward"]
    kd = K.blend_backward(*b, **bkw)
    pd = P.blend_backward_plain(*b, **bkw)
    torch.cuda.synchronize()
    err4 = 0.0
    kinds = {"mean2d": slice(0, 2), "conic": slice(2, 5),
             "opacity": slice(5, 6), "jinv": slice(6, 10),
             "lam": slice(10, 12), "plain": slice(12, 12 + ca),
             "vertex": slice(12 + ca, None)}
    for kind, sl in kinds.items():
        if pd[:, sl].numel() == 0:
            continue
        e = max_err_rel(kd[:, sl], pd[:, sl])
        err4 = max(err4, float((kd[:, sl] - pd[:, sl]).abs().max()))
        if e > TOL_ROWS:
            raise AssertionError(f"B4 [{label}] {kind} rows differ by {e} of "
                                 "their largest magnitude")
    log(f"[kernels] {label}: B3 max|err| img {err_img:.3g} logT {err_lt:.3g} "
        f"wsum(rel) {err_w:.3g}; B4 max|err| {err4:.3g}; "
        f"n_contrib mismatches {nc_bad}")
    return err3, err4


# Float operations the blend needs per (pixel, instance) pair, by what the
# pair needs (an exp, log1p or division counts as one; a multiply-add as
# two; each nonzero term of a sum over the tile's pixels as one add):
#   test   every pair of a real row: offset, power, exp, alpha, both tests;
#   ok     the pair passes the footprint test: forward log1p and logT update;
#          backward loga, logT_excl, the logT part of d_alpha, d_power and
#          the six geometry rows (mean2d, conic, opacity) with their sums;
#   gated  ok and above the transmittance threshold: the weight, the plain
#          channel sums (forward) or dw, the plain rows and the weight part
#          of d_alpha (backward); with CV > 0 also the bilinear (u, v), the
#          vertex sums or rows, and in the backward d_Jinv and d_lam.
# Pairs past the footprint and padding rows need nothing more: their
# contributions and gradient terms are exactly zero.
FWD_TEST, FWD_OK = 16, 4
BWD_TEST, BWD_OK = 16, 36


def fwd_gated_ops(ca, cv):
    return 4 + 2 * ca + (30 + 8 * cv if cv else 0)


def bwd_gated_ops(ca, cv, has_gwsum):
    return 7 + 4 * ca + int(has_gwsum) + (84 + 17 * cv if cv else 0)


def bounds(calls):
    """Least time (ms) the card could take for each kernel's work on the
    captured inputs: max(bytes / HBM rate, operations / float32 rate), each
    input read once and each output written once.  The blend's work is
    counted on these inputs by the plain forward: the real rows of the
    chunks each tile processes, and their (pixel, row) pairs that are
    tested, pass the footprint test, and blend."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas_strip as BS

    a, kw = calls["compute_counts"]
    ns = a[0].numel()
    T = kw["grid_x"] * kw["grid_y"]
    nchunks = ns // kw.get("gauss_chunk", 256)
    a2, kw2 = calls["compute_instances"]
    total_raw = int(a2[7])
    m = kw2["m"]
    b3, kw3 = calls["blend_forward"]
    slab, ts, tc = b3
    kr = slab.shape[1]
    ca, cv = kw3["ca"], kw3["cv"]
    b4, _ = calls["blend_backward"]
    g_wsum = b4[5]
    hw = b4[3].shape[1] * b4[3].shape[2]
    work = {}
    with torch.no_grad():
        BS.blend_forward_plain(*b3, **kw3, work=work)
    ops_fwd = (work["pairs"] * FWD_TEST + work["ok"] * FWD_OK
               + work["gated"] * fwd_gated_ops(ca, cv))
    ops_bwd = (work["pairs"] * BWD_TEST + work["ok"] * BWD_OK
               + work["gated"] * bwd_gated_ops(ca, cv, g_wsum is not None))
    out = {"blend_work": work}

    def bound(name, nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")

    bound("binning_counts", 16 * ns + 4 * T + 4 * nchunks * T, total_raw)
    bound("binning_instances", 24 * ns + 4 * nchunks * T + 8 * m,
          total_raw * max(1, math.ceil(math.log2(ns))))
    rows_b = 4 * work["rows"] * kr               # real slab rows, read once
    bound("blend_forward", rows_b + 4 * (ca + cv + 2) * hw + 12 * T
          + (4 * m if kw3.get("emit_wsum", True) else 0), ops_fwd)
    bound("blend_backward", rows_b + 4 * (ca + cv + 2) * hw + 8 * T
          + (4 * m if g_wsum is not None else 0) + 4 * m * kr, ops_bwd)
    return out


def library_counts(calls):
    """One-call-per-stage PyTorch yardstick of the B1 counts: corner
    bincount of the rect difference array, then a 2-D cumsum."""
    import torch
    a, kw = calls["compute_counts"]
    x0, y0, x1, y1 = (t.long() for t in a)
    gx, gy = kw["grid_x"], kw["grid_y"]
    W = gx + 1

    def fn():
        idx = torch.cat([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
        wts = torch.cat([torch.ones_like(x0), -torch.ones_like(x0),
                         -torch.ones_like(x0), torch.ones_like(x0)])
        d = torch.bincount(idx, weights=wts.float(),
                           minlength=(gy + 1) * W).view(gy + 1, W)
        return d.cumsum(0).cumsum(1)[:gy, :gx]
    return fn


def profile_step(fn, out_dir, name="chip_smoke_profile.txt"):
    """torch.profiler table of one train step (after a warm-up), sorted by
    device time, written to ``out_dir/name``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)
    log(f"[profile] one train step ({name}), by device time:")
    for line in table.splitlines()[:25]:
        log("[profile] " + line)


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

S2_SAMPLES = 24         # incident samples per surfel (bench_stage2.py)
S2_ENV_H = 32           # env map 32 x 64


def stage2_inputs(state, device, *, samples=S2_SAMPLES, env_h=S2_ENV_H,
                  seed=2):
    """bench_stage2.py:69-92 on ``state``: upgrade_to_pbr, a synthetic bake
    (its values do not change the step's cost) with the equirect
    coordinates of its incident directions, radiances from the bake and a
    fresh env map, all drawn from one seeded generator."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator(device=device).manual_seed(seed)
    n = state["params"]["xyz"].shape[0]
    st = G.upgrade_to_pbr(state)
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(n, 3, generator=g, device=device)), samples)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {
        "radiance": torch.rand(n, samples, 3, generator=g, device=device),
        "visibility": (torch.rand(n, samples, 1, generator=g, device=device)
                       > 0.3).float(),
        "incident_dirs": inc, "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": torch.randint(-1, n, (n, samples), generator=g,
                                 device=device),
        "uv": torch.rand(n, samples, 2, generator=g, device=device),
    }
    params = dict(st["params"])
    params["radiances"] = bake["radiance"].clone()
    params["radiance_ratio"] = torch.ones((), device=device)
    env = LT.direct_light_map_init(env_h, OptimizationConfig().light_init,
                                   generator=g, device=device)
    return {**st, "params": params}, bake, env


def compare_env(calls, label):
    """B7 forward and backward kernel vs plain on the captured inputs;
    returns the max absolute errors."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    with torch.no_grad():
        a, _ = calls["env_lookup_forward"]
        kf, pf = K.env_lookup_forward(*a), P.env_lookup_forward_plain(*a)
        b, bkw = calls["env_lookup_backward"]
        kb = K.env_lookup_backward(*b, **bkw)
        pb = P.env_lookup_backward_plain(*b, **bkw)
        torch.cuda.synchronize()
    ef = float((kf - pf).abs().max())
    eb = float((kb - pb).abs().max())
    scale = max(float(pb.abs().max()), 1e-30)
    log(f"[kernels] {label}: B7 forward max|err| {ef:.3g} over "
        f"{a[1].numel()} queries; backward max|err| {eb:.3g} "
        f"({eb / scale:.3g} of max |d_env| {scale:.4g})")
    if ef > TOL_ENV_FWD:
        raise AssertionError(f"B7 [{label}] forward differs by {ef}")
    if eb > TOL_ENV_BWD * scale:
        raise AssertionError(f"B7 [{label}] backward differs by {eb}")
    return ef, eb


# Float operations of B7 per query: each of the two coordinates' taps
# (floor, two clamps of the floor, subtract, two clamps of the fraction,
# convert, compare-select: 8), the two complements (2); per channel the
# forward's three lerps (3 each), the backward's two tap weights and four
# weighted adds into d_env (10).
ENV_TAP_OPS = 18


def env_bounds(calls):
    """Least time (ms) of B7's forward and backward on the captured inputs:
    each query's u, v read once, its samples (forward) or cotangents
    (backward) once, the env read (forward) or d_env written (backward)
    once."""
    a, _ = calls["env_lookup_forward"]
    h, w, c = a[0].shape
    m = a[1].numel()
    nb = 4 * (2 * m + m * c + h * w * c)
    out = {}
    for name, ops in (("env_lookup_forward", m * (ENV_TAP_OPS + 9 * c)),
                      ("env_lookup_backward", m * (ENV_TAP_OPS + 10 * c))):
        tb, to = nb / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def library_env(calls):
    """One-call PyTorch yardsticks of B7: grid_sample(align_corners=True)
    on the same env and coordinates, and its env gradient alone."""
    import torch
    import torch.nn.functional as F

    env, u, v = calls["env_lookup_forward"][0]
    h, w, c = env.shape
    envt = env.detach().permute(2, 0, 1)[None].contiguous()   # [1, C, H, W]
    grid = torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1],
                       -1)[None, None]                           # [1, 1, M, 2]
    g = calls["env_lookup_backward"][0][2]
    gout = g.t().contiguous()[None, :, None, :]                  # [1, C, 1, M]
    return {
        "env_lookup_forward": lambda: F.grid_sample(
            envt, grid, mode="bilinear", align_corners=True),
        "env_lookup_backward": lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, envt, grid, 0, 0, True, [True, False]),
    }


def small_stage2(device, n=2000, res=96, samples=8, seed=3):
    """A small stage-2 scene on ``device``, made on the CPU from a seeded
    generator: surfels on a sphere facing a close camera, random PBR
    parameters, a synthetic bake and a 16x32 env."""
    import dataclasses

    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.models import gaussians as G

    g = torch.Generator().manual_seed(seed)
    dirs = torch.randn(n, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    state = G.init_from_points(dirs, torch.rand(n, 3, generator=g),
                               normals=dirs, capacity=n,
                               rotation_init="normal", device="cpu")
    state, bake, env = stage2_inputs(state, "cpu", samples=samples,
                                     env_h=16, seed=seed)
    p = state["params"]
    p["opacity"] = torch.randn(n, 1, generator=g) + 0.5
    p["base_color"] = 0.5 * torch.randn(n, 12, generator=g)
    p["roughness"] = 0.5 * torch.randn(n, 4, generator=g)
    p["normal"] = 0.1 * torch.randn(n, 12, generator=g)
    cam = look_at_camera(eye=[0.3, 0.2, -2.2], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device="cpu")
    cam = dataclasses.replace(cam, image=torch.rand(3, res, res,
                                                    generator=g),
                              image_mask=torch.ones(1, res, res))

    def to(x):
        return x.to(device) if torch.is_tensor(x) else x
    cam = dataclasses.replace(cam, **{
        f.name: to(getattr(cam, f.name)) for f in dataclasses.fields(cam)})
    state = {**state, "params": {k: to(v) for k, v in p.items()},
             "alive": to(state["alive"])}
    return state, {k: to(v) for k, v in bake.items()}, \
        {"env": to(env["params"]["env"])}, cam


def run_small_stage2(device):
    """The small stage-2 scene's eval images, train-mode loss and
    gradients (every parameter group and the env) on ``device``."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.render.svgss import render_svgss, render_view_svgss

    state, bake, env, cam = small_stage2(device)
    cfg = RasterConfig(max_instances=1 << 18)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        ev = render_view_svgss(cam, state["params"], bake, env, bg,
                               is_training=False, alive=state["alive"],
                               cfg=cfg)
    p = {k: v.clone().requires_grad_(True)
         for k, v in state["params"].items()}
    e = env["env"].clone().requires_grad_(True)
    opt = OptimizationConfig(lambda_base_color_smooth=0.1,
                             lambda_roughness_smooth=0.05,
                             lambda_env_smooth=0.02)
    r = render_svgss(cam, p, bg, bake=bake, env_params={"env": e}, opt=opt,
                     is_training=True, alive=state["alive"], cfg=cfg)
    names = list(p)
    grads = torch.autograd.grad(r["loss"], [p[k] for k in names] + [e],
                                allow_unused=True)
    out = {k: g for k, g in zip(names + ["env"], grads) if g is not None}
    return ev, r, out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    try:
        import svgir_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (svgir_tpu_torch "
              "not importable)", file=sys.stderr)
        return 2

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.kernels import build
    from svgir_tpu_torch.ops import binning_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import optim, trainer

    dev = "cuda"
    t_start = time.time()
    # ---- 1. build ------------------------------------------------------
    t0 = time.time()
    build.build()
    for stem in ("binning", "blend_forward", "blend_backward"):
        build.library(stem)
    card = nvidia_smi()
    log(f"[build] {time.time() - t0:.1f} s; card: {card}")
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines() \
            if (build.BUILD_DIR / "build.log").exists() else []:
        if any(k in line for k in ("registers", "spill", "Function properties",
                                   "==")):
            log("[ptxas] " + line.strip())

    # ---- 2. render (eval path) ----------------------------------------
    state, cam = bench_scene(dev)
    opt = OptimizationConfig()
    cfg = RasterConfig()
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad(), Capture() as cap_render:
        res = render_view_stage1(cam, state["params"], bg,
                                 alive=state["alive"], cfg=cfg)
    torch.cuda.synchronize()
    render_launches = kernels.launches()
    padded = int(cap_render.calls["blend_forward"][0][2].sum())
    cfg_default = cfg
    cfg = RasterConfig(max_instances=-(-padded * 21 // (20 * 2048)) * 2048)
    img = res["render"]
    if tuple(img.shape) != (3, 800, 800) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render: bad image")
    if bool(res["overflow"]):
        raise AssertionError("render: binner overflow")
    log(f"[render] 800x800, 50k surfels: mean {float(img.mean()):.5f}, "
        f"covered {float((res['n_contrib'] > 0).float().mean()):.4f}, "
        f"launches {render_launches}; padded instances {padded} -> cap "
        f"{cfg.max_instances}")
    for k in ("binning_counts", "binning_instances", "blend_forward"):
        if render_launches[k] < 1:
            raise AssertionError(f"render path did not launch {k}")

    # ---- 3. train (main path) -----------------------------------------
    steps = 5
    torch.cuda.synchronize()
    kernels.reset_launches()
    st, ost, hist = trainer.train_stage1(
        state, [cam], opt, raster_cfg=cfg, iterations=steps, log_every=1,
        device=dev)
    torch.cuda.synchronize()
    train_launches = kernels.launches()
    log(f"[train] {steps} steps: " + ", ".join(
        f"it {h['iter']} loss {h['loss']:.6f} psnr {h['psnr']:.4f}"
        for h in hist))
    log(f"[train] launches {train_launches}")
    for h in hist:
        if not math.isfinite(h["loss"]) or h.get("overflow"):
            raise AssertionError(f"train: bad step {h}")
    for k, v in list(st["params"].items()) + list(ost["m"].items()) + \
            list(ost["v"].items()):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"train: non-finite values in {k}")
    if not any(bool((ost["m"][k] != 0).any()) for k in ost["m"]):
        raise AssertionError("train: all gradients are zero")
    for k in STAGE1_KERNELS:
        if train_launches[k] < 1:
            raise AssertionError(f"train path did not launch {k}")

    # ---- 4. kernels vs plain ------------------------------------------
    step = trainer.make_train_step(opt, cfg, bg, lrs=optim.group_lrs(opt, 1.0),
                                   device=dev)
    ost0 = optim.adam_init(state["params"])
    with Capture() as cap_bench:
        step(state, ost0, cam, 1.0, 1.6e-4)
    torch.cuda.synchronize()
    calls = cap_bench.calls
    compare_binning(calls)
    log("[kernels] bench: B1, B2 equal to their plain versions")
    err3, err4 = compare_blend(calls, "bench")

    sc_dev, cam_dev = small_scene(dev)
    with Capture() as cap_small:
        bufs_dev, grads_dev = run_small(sc_dev, cam_dev, dev)
    torch.cuda.synchronize()
    cv = cap_small.calls["blend_forward"][1]["cv"]
    eff_s = cap_small.calls["blend_backward"][0][2]
    tc_s = cap_small.calls["blend_forward"][0][2] // 128
    if cv < 1 or int(eff_s.max()) < 2 or not bool((eff_s < tc_s).any()) \
            or cap_small.calls["blend_backward"][0][5] is None:
        raise AssertionError("small scene does not exercise CV > 0, multiple "
                             "chunks, early exit and g_wsum")
    compare_binning(cap_small.calls)
    e3s, e4s = compare_blend(cap_small.calls, "small CV=2")
    err3, err4 = max(err3, e3s), max(err4, e4s)

    # ---- 5. parity: card (kernels) vs CPU (plain versions) -------------
    sc_cpu, cam_cpu = small_scene("cpu")
    bufs_cpu, grads_cpu = run_small(sc_cpu, cam_cpu, "cpu")
    for f in ("color", "depth", "normal", "feature", "vfeature", "opacity"):
        e = max_err_rel(getattr(bufs_dev, f).detach().cpu(),
                        getattr(bufs_cpu, f).detach())
        if e > 1e-4:
            raise AssertionError(f"parity: {f} differs by {e} (relative)")
    for k in grads_cpu:
        e = max_err_rel(grads_dev[k].cpu(), grads_cpu[k])
        if e > 1e-3:
            raise AssertionError(f"parity: d{k} differs by {e} (relative)")
    log("[parity] small scene: card == CPU (image 1e-4, gradients 1e-3 of "
        "max)")

    # ---- 6. timing ------------------------------------------------------
    from svgir_tpu_torch.kernels import binning as KB
    from svgir_tpu_torch.kernels import blend as KBL
    a1, kw1 = calls["compute_counts"]
    kk1 = dict(grid_x=kw1["grid_x"], grid_y=kw1["grid_y"],
               gauss_chunk=kw1.get("gauss_chunk", 256))
    a2, kw2 = calls["compute_instances"]
    a3, kw3 = calls["blend_forward"]
    a4, kw4 = calls["blend_backward"]
    timed = {
        "binning_counts": (lambda: KB.counts(*a1, **kk1),
                           lambda: BP.counts_plain(*a1, **kk1),
                           library_counts(calls)),
        "binning_instances": (lambda: KB.instances(*a2, **kw2),
                              lambda: BP.instances_plain(*a2, **kw2), None),
        "blend_forward": (lambda: KBL.blend_forward(*a3, **kw3),
                          lambda: BS.blend_forward_plain(*a3, **kw3), None),
        "blend_backward": (lambda: KBL.blend_backward(*a4, **kw4),
                           lambda: BS.blend_backward_plain(*a4, **kw4), None),
    }
    replaces = {
        "binning_counts": "svgir_tpu/ops/binning_pallas.py:44",
        "binning_instances": "svgir_tpu/ops/binning_pallas.py:114",
        "blend_forward": "svgir_tpu/ops/blend_pallas_strip.py:51",
        "blend_backward": "svgir_tpu/ops/blend_pallas_strip.py:267",
    }
    sources = {
        "binning_counts": "svgir_tpu_torch/csrc/binning.cu",
        "binning_instances": "svgir_tpu_torch/csrc/binning.cu",
        "blend_forward": "svgir_tpu_torch/csrc/blend_forward.cu",
        "blend_backward": "svgir_tpu_torch/csrc/blend_backward.cu",
    }
    errs = {"binning_counts": 0.0, "binning_instances": 0.0,
            "blend_forward": err3, "blend_backward": err4}
    bnd = bounds(calls)
    wk = bnd["blend_work"]
    log(f"[timing] blend work on the bench inputs: {wk['rows']} real rows "
        f"in processed chunks, {wk['pairs']} (pixel, row) pairs, {wk['ok']} "
        f"pass the footprint test, {wk['gated']} blend")
    report = []
    for name, (kfn, pfn, lfn) in timed.items():
        ms = cuda_ms(kfn, reps=20)
        pms = cuda_ms(pfn, reps=3, warmup=1)
        lms = cuda_ms(lfn, reps=20) if lfn else None
        report.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "library_ms": lms})
        log(f"[timing] {name}: {ms:.4f} ms (plain {pms:.3f} ms, bound "
            f"{bnd[name][0]:.4f} ms by {bnd[name][1]}"
            + (f", bincount+cumsum {lms:.4f} ms" if lms else "")
            + f"); card: {card}")

    def render_once(c):
        with torch.no_grad():
            render_view_stage1(cam, state["params"], bg, alive=state["alive"],
                               cfg=c)
    step_default = trainer.make_train_step(
        opt, cfg_default, bg, lrs=optim.group_lrs(opt, 1.0), device=dev)
    for label, c, fn in (("snug", cfg, step), ("default", cfg_default,
                                               step_default)):
        render_ms = host_ms(lambda: render_once(c), reps=10)
        step_ms = host_ms(lambda: fn(state, ost0, cam, 1.0, 1.6e-4), reps=10)
        log(f"[timing] cap {c.max_instances} ({label}): render 800x800/50k "
            f"forward {render_ms:.3f} ms; train step {step_ms:.3f} ms; "
            f"card: {card}")
    log(f"[timing] instances {int(a2[7])} (padded {int(a3[2].sum())}); the "
        "four kernels' sum per step: "
        f"{sum(r['ms'] for r in report):.3f} ms")
    log(f"[stage 1] {time.time() - t_start:.1f} s")

    # ---- 7. stage-2 render (eval path) ---------------------------------
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.render.svgss import render_view_svgss

    s2_state, bake, env0 = stage2_inputs(state, dev)
    alive = s2_state["alive"]

    def render_s2():
        with torch.no_grad():
            return render_view_svgss(cam, s2_state["params"], bake,
                                     env0["params"], bg, is_training=False,
                                     alive=alive, cfg=cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap_s2_render:
        res2 = render_s2()
    torch.cuda.synchronize()
    s2_render_launches = kernels.launches()
    for k in ("render", "pbr", "pbr_env", "render_env", "base_color",
              "direct", "indirect"):
        if tuple(res2[k].shape) != (3, 800, 800) or \
                not bool(torch.isfinite(res2[k]).all()):
            raise AssertionError(f"stage-2 render: bad {k} image")
    if bool(res2["overflow"]):
        raise AssertionError("stage-2 render: binner overflow")
    log(f"[s2 render] 800x800, 50k surfels, S={S2_SAMPLES}, env "
        f"{S2_ENV_H}x{2 * S2_ENV_H}: pbr mean {float(res2['pbr'].mean()):.5f}"
        f", pbr_env mean {float(res2['pbr_env'].mean()):.5f}, launches "
        f"{s2_render_launches}")
    for k in ("env_lookup_forward", "blend_forward"):
        if s2_render_launches[k] < 1:
            raise AssertionError(f"stage-2 render did not launch {k}")

    # ---- 8. stage-2 train (main path) ----------------------------------
    lrs2 = optim.group_lrs(opt, 1.0, use_pbr=True)
    step2 = trainer.make_svgss_train_step(opt, cfg, bg, lrs=lrs2,
                                          device=dev)
    st2 = {**s2_state, "stats": state["stats"]}
    ost2, env2 = optim.adam_init(st2["params"]), env0
    torch.cuda.synchronize()
    kernels.reset_launches()
    s2_hist = []
    for i in range(steps):
        st2, ost2, env2, tb2 = step2(st2, ost2, env2, bake, cam,
                                     100.0 + i, 1e-5, opt.radiance_lr)
        s2_hist.append((float(tb2["loss"]), float(tb2["psnr_pbr"]),
                        bool(tb2["overflow"])))
    torch.cuda.synchronize()
    s2_train_launches = kernels.launches()
    log(f"[s2 train] {steps} steps: " + ", ".join(
        f"loss {l:.6f} psnr_pbr {q:.4f}" for l, q, _ in s2_hist))
    log(f"[s2 train] launches {s2_train_launches}")
    if any(not math.isfinite(l) or o for l, _, o in s2_hist):
        raise AssertionError(f"stage-2 train: bad step {s2_hist}")
    tensors = list(st2["params"].items()) + list(ost2["m"].items()) + \
        list(ost2["v"].items()) + [("env", env2["params"]["env"]),
                                   ("env m", env2["opt"]["m"]["env"]),
                                   ("env v", env2["opt"]["v"]["env"])]
    for k, v in tensors:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"stage-2 train: non-finite values in {k}")
    if not bool((env2["opt"]["m"]["env"] != 0).any()):
        raise AssertionError("stage-2 train: the env got no gradient")
    for k in kernels.KERNEL_NAMES:
        if s2_train_launches[k] < steps:
            raise AssertionError(f"stage-2 train launched {k} "
                                 f"{s2_train_launches[k]} times in {steps} "
                                 "steps")

    # ---- 9. stage-2 kernels vs plain ------------------------------------
    ost2_0 = optim.adam_init(s2_state["params"])
    s2_args = ({**s2_state, "stats": state["stats"]}, ost2_0, env0, bake,
               cam, 100.0, 1e-5, opt.radiance_lr)
    with Capture() as cap_s2:
        step2(*s2_args)
    torch.cuda.synchronize()
    c2 = cap_s2.calls
    kw_s2 = c2["blend_forward"][1]
    kw_s2e = cap_s2_render.calls["blend_forward"][1]
    if (kw_s2["ca"], kw_s2["cv"]) != (13, 13) or \
            (kw_s2e["ca"], kw_s2e["cv"]) != (16, 16):
        raise AssertionError("stage-2 blend widths are not CA/CV 13/13 "
                             "(train) and 16/16 (eval)")
    e7f, e7b = compare_env(c2, "stage-2 step")
    compare_binning(c2)
    e3s2, e4s2 = compare_blend(c2, "stage-2 step CA=13 CV=13")
    e3s2e, _ = compare_blend(cap_s2_render.calls, "stage-2 eval CA=16 CV=16")

    # ---- 10. stage-2 parity: card vs CPU --------------------------------
    ev_d, r_d, g_d = run_small_stage2(dev)
    ev_c, r_c, g_c = run_small_stage2("cpu")
    for k in ("render", "pbr", "base_color", "roughness", "direct",
              "indirect", "pbr_env", "render_env", "opacity"):
        f = 2 if k in ("direct", "indirect") else 1
        e = float((ev_d[k].cpu() - ev_c[k]).abs().max())
        if e > f * TOL_S2_IMG:
            raise AssertionError(f"s2 parity: {k} differs by {e}")
    e = float(((ev_d["depth"].cpu() - ev_c["depth"]).abs()
               / ev_c["depth"].abs().clamp(min=1e-6)).max())
    if e > TOL_S2_DEPTH:
        raise AssertionError(f"s2 parity: depth differs by {e} (relative)")
    el = abs(r_d["loss"].item() - r_c["loss"].item())
    if el > 1e-5 * max(1.0, abs(r_c["loss"].item())):
        raise AssertionError(f"s2 parity: loss differs by {el}")
    if sorted(g_d) != sorted(g_c):
        raise AssertionError("s2 parity: different groups got gradients")
    worst = max((max_err_rel(g_d[k].cpu(), g_c[k]), k) for k in g_c)
    if worst[0] > TOL_S2_GRAD:
        raise AssertionError(f"s2 parity: d{worst[1]} differs by {worst[0]} "
                             "of its largest magnitude")
    log(f"[s2 parity] small stage-2 scene: card == CPU (images "
        f"{TOL_S2_IMG}, depth {TOL_S2_DEPTH} relative, loss within {el:.3g},"
        f" gradients within {worst[0]:.3g} of max, worst d{worst[1]})")

    # ---- 11. stage-2 timing ---------------------------------------------
    step2_ms = host_ms(lambda: step2(*s2_args), reps=10)
    render2_ms = host_ms(render_s2, reps=10)
    log(f"[s2 timing] cap {cfg.max_instances}: stage-2 train step "
        f"{step2_ms:.3f} ms; eval render {render2_ms:.3f} ms; card: {card}")
    bnd2 = bounds(c2)
    bnd2e = bounds({**c2, "blend_forward": cap_s2_render.calls[
        "blend_forward"]})
    bnd_env = env_bounds(c2)
    lib_env = library_env(c2)
    fa, _ = c2["env_lookup_forward"]
    ba, bkw = c2["env_lookup_backward"]
    b3, kw3s = c2["blend_forward"]
    b4, kw4s = c2["blend_backward"]
    b3e, kw3e = cap_s2_render.calls["blend_forward"]
    timed2 = {
        "env_lookup_forward": (
            lambda: KE.env_lookup_forward(*fa),
            lambda: EP.env_lookup_forward_plain(*fa),
            "svgir_tpu/ops/env_lookup_pallas.py:63",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7f,
            bnd_env["env_lookup_forward"], lib_env["env_lookup_forward"]),
        "env_lookup_backward": (
            lambda: KE.env_lookup_backward(*ba, **bkw),
            lambda: EP.env_lookup_backward_plain(*ba, **bkw),
            "svgir_tpu/ops/env_lookup_pallas.py:76",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7b,
            bnd_env["env_lookup_backward"], lib_env["env_lookup_backward"]),
        "blend_forward_stage2": (
            lambda: KBL.blend_forward(*b3, **kw3s),
            lambda: BS.blend_forward_plain(*b3, **kw3s),
            replaces["blend_forward"], sources["blend_forward"],
            s2_train_launches, e3s2, bnd2["blend_forward"], None),
        "blend_backward_stage2": (
            lambda: KBL.blend_backward(*b4, **kw4s),
            lambda: BS.blend_backward_plain(*b4, **kw4s),
            replaces["blend_backward"], sources["blend_backward"],
            s2_train_launches, e4s2, bnd2["blend_backward"], None),
        "blend_forward_stage2_eval": (
            lambda: KBL.blend_forward(*b3e, **kw3e),
            lambda: BS.blend_forward_plain(*b3e, **kw3e),
            replaces["blend_forward"], sources["blend_forward"],
            s2_render_launches, e3s2e, bnd2e["blend_forward"], None),
    }
    for name, (kfn, pfn, rep, src, lc, err, bd, lfn) in timed2.items():
        ms = cuda_ms(kfn, reps=20)
        pms = cuda_ms(pfn, reps=3, warmup=1)
        lms = cuda_ms(lfn, reps=20) if lfn else None
        key = name.replace("_stage2_eval", "").replace("_stage2", "")
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lc[key], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bd[0], "bound_by": bd[1],
            "library_ms": lms})
        log(f"[s2 timing] {name}: {ms:.4f} ms (plain {pms:.3f} ms, bound "
            f"{bd[0]:.4f} ms by {bd[1]}"
            + (f", grid_sample {lms:.4f} ms" if lms else "")
            + f"); card: {card}")
    wk2 = bnd2["blend_work"]
    log(f"[s2 timing] blend work on the stage-2 step's inputs: {wk2['rows']} "
        f"real rows, {wk2['pairs']} pairs, {wk2['ok']} pass the footprint "
        f"test, {wk2['gated']} blend; {fa[1].numel()} env queries per step")

    if "--profile" in sys.argv[1:-1]:
        out_dir = sys.argv[sys.argv.index("--profile") + 1]
        profile_step(lambda: step(state, ost0, cam, 1.0, 1.6e-4), out_dir)
        profile_step(lambda: step2(*s2_args), out_dir,
                     "chip_smoke_profile_stage2.txt")
    log(f"[done] {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
