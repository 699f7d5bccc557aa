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
    """Records the arguments the rasterizer passes to the four kernel
    entry points (ops functions looked up at call time)."""

    def __init__(self):
        from svgir_tpu_torch.ops import binning, blend_pallas_strip
        self.targets = [(binning, "compute_counts"),
                        (binning, "compute_instances"),
                        (blend_pallas_strip, "blend_forward"),
                        (blend_pallas_strip, "blend_backward")]
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


def profile_step(fn, out_dir):
    """torch.profiler table of one train step (after a warm-up), sorted by
    device time, written to ``out_dir/chip_smoke_profile.txt``."""
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
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    log("[profile] one train step, by device time:")
    for line in table.splitlines()[:25]:
        log("[profile] " + line)


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
    for k in kernels.KERNEL_NAMES:
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
    if "--profile" in sys.argv[1:-1]:
        profile_step(lambda: step(state, ost0, cam, 1.0, 1.6e-4),
                     sys.argv[sys.argv.index("--profile") + 1])
    log(f"[done] {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
