#!/usr/bin/env python3
"""Smoke run of svgir_tpu_torch on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py            # all phases, from the repository root
    python3 chip_smoke.py --profile DIR   # also write torch.profiler
                                          # tables of stage-1, stage-2 and
                                          # S = 64 steps and a bake to DIR
    python3 chip_smoke.py --parent DIR    # also time the blend, B2, B7's
                                          # backward, B8 and B9 kernels of
                                          # another checkout DIR
                                          # (its own wrappers, built there)
                                          # in turns beside this tree's;
                                          # repeatable

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build    compile csrc/*.cu with nvcc (in parallel) and load them
              (launch_floor.cu is an empty kernel, timed in 6);
              print the card's name and power limit, and the registers,
              stack and spills of every blend instantiation (ptxas -v).
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
              the tolerances below.  B1 also on the bench scene at tile 16
              (2,500 tiles) and on the synthetic rects of the CPU tests
              (tests/torch_kernel_inputs.py: full-grid, empty, inverted,
              edge-ending and out-of-grid rects, one chunk, tile 16 on a
              non-square grid) and on grids past one block's shared memory
              (256 x 256, counted in bands of tile rows; 60,000 x 3, in
              bands of a row's columns).  B2 also at tile 16 and on the
              edge cases of the CPU tests (instance_inputs: a chunk whose
              256 rects all cover one tile, one of empty and inverted
              rects, a last chunk ending in padding, m past and below
              total_raw, a 50 x 50 grid, the two wide grids, walked in
              bands) and on the synthetic rects clipped to their grids.
              B3/B4 also on the blend's edge
              inputs of the CPU tests (a tile with no chunk, one that
              saturates in its first chunk, padding rows among real ones,
              alpha clamped at 0.99, u and v past their clamps; CA/CV
              14/0, 13/13, 16/16 and 3/4) at every tile the wrappers take
              (32, 24, 16 and 8).
  5. parity   the small scene rendered forward and backward on the card
              (kernels) and on the CPU (plain versions): image and
              gradients agree.
  6. timing   median times of the render and the train step (at the snug
              and at the default cap), of each kernel, its plain version
              and, for B1, a bincount + cumsums yardstick of its whole
              function (counts and carry; the counts-only one beside it).
              Every kernel row, here and in 11, 16 and 23, has its per-call
              ms (CUDA events around each Python call: host time
              included) and its device_ms (torch.profiler's durations of
              the device operations over 20 back-to-back calls), and so
              has its library yardstick.  The blend rows add the kernel
              each launch takes (registers, spills, blocks per SM) and,
              with --parent, the other tree's kernels timed in turns
              beside them; the work
              counts give the warp visits of each warp patch (the shuffle
              model of the backward).  B1 is timed on the 256 x 256 grid
              with its yardstick; with --parent, B2 in turns with the
              other tree's.  The launch floor: an empty kernel's device
              time (one block of 32 threads, and B2's grid), beside the
              bounds below it (launch_floor_device_ms in every row).
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
                 B3 at CA 16 / CV 16 on the eval render's inputs; B7's
                 forward also on both of the eval render's lookups and on
                 the edge cases of the CPU tests (envs 16x32 and 32x64, M
                 37, 1,027 and 20,003, and each one shorter and not
                 16-byte aligned), the backward too; the backward on a
                 64x128 env (one copy of d_env a block); forward and
                 backward on envs past one block's shared memory (128x256,
                 256x512: read in place, gradient summed in slices).
                 Then one stage-2 step with a 128x256 env
                 (train.py --env_resolution 128): finite, the env
                 gradient nonzero, B7 against its plain version on it.
  10. s2 parity  a small stage-2 scene rendered and stepped on the card and
                 on the CPU, with a 16x32 and a 128x256 env: images, loss
                 and gradients agree.
  11. s2 timing  stage-2 train step and eval render medians; B7 with its
                 plain version, bound and grid_sample yardstick (the
                 forward also on each eval lookup, and both on the env-128
                 step); B3/B4 at stage-2 width; with --parent, B7's
                 backward on both steps' cotangents in turns with the other
                 tree's (the two held within TOL_ENV_BWD).
  The radiance bake that starts stage 2 (the bench scene upgraded to PBR,
  S = 64 samples per surfel and a 32x64 env as the recipe's --sample_num 64
  --env_resolution 32 (script/run_tensoir.sh), k_hits 16; the
  configuration's default env is 16x32, and H = 128 only
  direct_light_map_init's default argument):
  12. bake+train train_stage2(bake=None) for three steps: the bake over
                 the 50k surfels (grid march on B8), then the steps; launch
                 counts reset just before and read just after; B8 and the
                 step's kernels launched; exhausted share, bake seconds,
                 finite loss, moments and parameters; one S = 64 step's
                 time and peak memory; B7 forward and backward on that
                 step's 3.2M lookups against their plain versions and
                 timed (with grid_sample, bound and launches; with
                 --parent, the backward in turns with the other tree's).
                 The bench surfels face outward, so
                 no ray of this bake hits a front face: the same surfels
                 turned inward are baked too (bake_radiance, S = 64, k 16;
                 most rays hit and lists fill), with one S = 64 step on
                 that bake.
  13. march      B8 against its plain version (march_plain) on the first
                 ray chunk (65,536 rays) of each of those bakes and on a
                 small bake's rays (3,000 surfels facing inward), also at
                 k 8, 32, 64 and 128 on 8,192 of them: idx equal and t
                 equal on every slot, or within the stated count.
  14. oracle     the grid march through B8 (nearest_hits_grid) against the
                 brute tracer (nearest_hits) on the 4,096 rays with the
                 most hits of each of those ray sets.
  15. bake parity a small bake on the card (B8) against the CPU's plain
                 path.
  16. bake timing a second, warm bake (seconds, launches per bake) and a
                 warm inward bake; B8's ms per launch on both first chunks
                 with its plain version and its bound, counted from the
                 visits each chunk's data needs; the brute and the grid
                 bake at 3,000 and 6,000 surfels (either side of the
                 switch at 4,096); with --parent, B8 on both first chunks
                 in turns with the other tree's (held hit for hit).
  The tile-major paths (RasterConfig(strip=0), train.py --strip 0, and the
  sort binner, binner="sort") with B5/B6 (csrc/blend_forward.cu,
  csrc/blend_backward.cu, tile-major entries) and the column copies B9:
  17. strip0 train  five train_stage1 steps with strip=0 at the snug cap:
                 finite, no overflow; B5/B6 launched every step, B3/B4
                 never; launch counts reset just before and read just after.
  18. strip0 kernels B5/B6 against their plain versions on one strip-0
                 step's inputs, and against B3/B4 on the same inputs: B5's
                 output assembled to image layout equals B3's image within
                 TOL_IMG with eff equal, B6's rows B4's within TOL_ROWS,
                 and bit-equal to them; also on the blend's edge inputs.
  19. strip0 s2  five stage-2 steps (S = 24) and an eval render at strip 0;
                 B5/B6 at CA 13 / CV 13 and B5 at 16 / 16 checked as in 18.
  20. sort       render_view_stage1 with the sort binner at the snug cap:
                 B5 launched, B1-B4 not; its integers on the card equal the
                 CPU's on the same preprocess outputs and the counting
                 binner's layout; the image equals the counting render.
  21. small      the small scene forward and backward on both tile-major
                 branches, card against CPU, and against the port's dense
                 oracle render_dense on the card.
  22. cols       B9 (pad_cols / slice_cols) against F.pad and the slice
                 copy, bitwise, at M = the cap rounded up to 1024, stage-1
                 KR -> 128 -> KR; the slice also at kout 1, 127 and 13, at
                 M = 1024 and on an input off 8-byte alignment.  B9 has no
                 caller on any path.
  23. timing     strip-0 against strip-8 stage-1 steps in turns, the
                 renders (counting strip 8 / strip 0, sort) and the stage-2
                 step and eval render at both; B5/B6/B9 per launch with
                 their plain versions, bounds and (B9) F.pad / slice copy;
                 with --parent, B9 in turns with the other tree's.

The output ends with three lines: the kernels JSON, the nvidia-smi line
(the card's name and power limit), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
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
STAGE2_KERNELS = STAGE1_KERNELS + ("env_lookup_forward",
                                   "env_lookup_backward")

# B8 against its plain version: both round every operation of the surfel
# test in the same order, so they should agree hit for hit; a slot may
# differ only where expf and torch's exp part at an alpha threshold.
MARCH_SLOT_TOL = 1e-4   # share of a chunk's finite slots that may differ
# The small bake, card against CPU: the geometry (quaternion rotations,
# incident directions) differs by float32 rounding between the devices.
BAKE_HIT_TOL = 1e-3     # share of rays that may differ
BAKE_VAL_TOL = 1e-4     # absolute, radiance / visibility / uv

HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_S = 67e12      # H100 SXM float32 (and integer ALU) rate, non-tensor


def log(*a):
    print(*a, flush=True)


def kernel_inputs():
    """``tests/torch_kernel_inputs.py`` (numpy only), loaded by its path: a
    ``tests`` package installed elsewhere may shadow the repository's."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_kernel_inputs.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def device_ms(fn, reps=20):
    """Device time of one fn() in ms, from the card's own clock: the
    durations torch.profiler records for the device operations (kernels,
    memsets, copies) of ``reps`` back-to-back calls, without the host time
    of each call (argument checks, allocation, launch).  Returns (ms,
    device operations per call, share of those launches the profiler
    recorded).

    On the H100 machine the profiler drops some device records, more as a
    run goes on (up to 19 of 20 launches of one kernel late in a run), so
    each operation is counted by name: its mean duration over the records
    it has, times its launches per call (its records over ``reps``,
    rounded up: right while fewer than ``reps`` of its records are lost).
    The window is padded on both sides so that records near its edges are
    kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return device_by_name(prof, reps)


def device_by_name(prof, reps):
    """(ms, operations, share recorded) per call of a profiled window of
    ``reps`` calls, each device operation counted by name as
    ``device_ms`` says."""
    import math

    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            n_us = by_name.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    if not by_name:
        raise AssertionError("torch.profiler recorded no device operation")
    per_call = {k: math.ceil(n / reps) for k, (n, _) in by_name.items()}
    ms = sum(us / n * per_call[k] for k, (n, us) in by_name.items()) / 1e3
    ops = sum(per_call.values())
    return ms, ops, sum(n for n, _ in by_name.values()) / (ops * reps)


def timings(kfn, pfn, lfn=None, *, reps=20, plain_reps=3):
    """The timing keys of a kernels-JSON entry: the wrapper's per-call
    ``ms`` (events around each call) and its ``device_ms``, the plain
    version's per-call ms, and the library call's per-call and device ms
    (None without one)."""
    dms, nk, rec = device_ms(kfn, reps=reps)
    out = {"ms": cuda_ms(kfn, reps=reps), "device_ms": dms,
           "device_ops": nk, "profiler_recorded": rec,
           "plain_ms": cuda_ms(pfn, reps=plain_reps, warmup=1),
           "library_ms": None, "library_device_ms": None}
    if lfn is not None:
        out["library_ms"] = cuda_ms(lfn, reps=reps)
        out["library_device_ms"] = device_ms(lfn, reps=reps)[0]
    return out


def fmt_times(t, lib_name=""):
    return (f"{t['ms']:.4f} ms per call, {t['device_ms']:.4f} ms on the "
            f"device ({t['device_ops']} device ops per call, "
            f"{t['profiler_recorded']:.2f} of them recorded; plain "
            f"{t['plain_ms']:.3f} ms"
            + (f"; {lib_name} {t['library_ms']:.4f} ms per call, "
               f"{t['library_device_ms']:.4f} ms on the device"
               if t["library_ms"] is not None else "") + ")")


def in_turns(old, new):
    """Another tree's kernel call ``old`` and this tree's ``new``, timed in
    turns (old, new, new, old): on the device and per call."""
    dev = [device_ms(f)[0] for f in (old, new, new, old)]
    call = [cuda_ms(f, reps=20) for f in (old, new, new, old)]
    return {"parent_device_ms": (dev[0] + dev[3]) / 2,
            "device_ms": (dev[1] + dev[2]) / 2,
            "parent_ms": (call[0] + call[3]) / 2,
            "ms": (call[1] + call[2]) / 2, "device_turns": dev,
            "call_turns": call}


def log_turns(o, what, card):
    log(f"[parent] {what}: device {o['device_ms']:.4f} ms (parent "
        f"{o['parent_device_ms']:.4f}), per call {o['ms']:.4f} ms (parent "
        f"{o['parent_ms']:.4f}); in turns parent/this/this/parent: device "
        + "/".join(f"{x:.4f}" for x in o["device_turns"]) + ", per call "
        + "/".join(f"{x:.4f}" for x in o["call_turns"]) + f"; card: {card}")


def launch_floor(blocks=1, threads=32):
    """One launch of the empty kernel of ``csrc/launch_floor.cu`` on
    ``blocks`` x ``threads``: what any launch costs on the card."""
    import ctypes

    import torch

    from svgir_tpu_torch.kernels import build
    fn = build.entry("launch_floor", "svgir_empty",
                     (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    s = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(blocks, threads, s), "svgir_empty")
    return launch


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


def bench_scene(device, n=50_000, res=800, seed=0, inward=False):
    """The scene of bench.py, with its random draws from torch; with
    ``inward`` the same surfels face the ball's centre (bake rays then
    meet front faces across the shell)."""
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator(device=device).manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g, device=device))
    r = 0.7 + 0.3 * torch.rand(n, 1, generator=g, device=device)
    cols = torch.rand(n, 3, generator=g, device=device)
    gt = torch.rand(3, res, res, generator=g, device=device)
    state = G.init_from_points(dirs * r, cols,
                               normals=-dirs if inward else dirs, capacity=n,
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
        from svgir_tpu_torch.ops import (binning, blend_pallas,
                                         blend_pallas_strip,
                                         env_lookup_pallas, rasterizer)
        # (module, function, key in ``calls``)
        self.targets = [
            (binning, "compute_counts", "compute_counts"),
            (binning, "compute_instances", "compute_instances"),
            (blend_pallas_strip, "blend_forward", "blend_forward"),
            (blend_pallas_strip, "blend_backward", "blend_backward"),
            (blend_pallas, "blend_forward", "blend_forward_tiles"),
            (blend_pallas, "blend_backward", "blend_backward_tiles"),
            (rasterizer, "bin_instances", "bin_instances"),
            (env_lookup_pallas, "env_lookup_forward", "env_lookup_forward"),
            (env_lookup_pallas, "env_lookup_backward",
             "env_lookup_backward")]
        self.calls = {}
        self.every = {}         # key -> the arguments of every call

    def __enter__(self):
        self.saved = []
        for mod, name, key in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def rec(*a, _fn=fn, _key=key, **kw):
                self.calls.setdefault(_key, (a, kw))
                self.every.setdefault(_key, []).append((a, kw))
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


def run_small(sc, cam, device, cfg=None):
    """Forward + backward of the small scene; returns (bufs, grads)."""
    import torch

    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.ops.rasterizer import rasterize

    cfg = cfg or RasterConfig(max_instances=1 << 18)
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


def compare_counts(a, kw, label):
    """B1 kernel vs plain on the rects ``a``: counts and carry equal
    integer for integer."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    from svgir_tpu_torch.ops import binning_pallas as P

    kk = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"],
              gauss_chunk=kw.get("gauss_chunk", 256))
    kc, kcar = K.counts(*a, **kk)
    pc, pcar = P.counts_plain(*a, **kk)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(kcar, pcar)):
        bad = int((kc != pc).sum() + (kcar != pcar).sum())
        raise AssertionError(f"B1 [{label}] counts kernel disagrees with its "
                             f"plain version at {bad} entries")
    return f"{label}: {kcar.shape[0]} chunks x {kc.numel()} tiles"


def compare_instances(a, kw, label, kernel=None):
    """B2 kernel (this tree's, or ``kernel``) vs plain on the arguments
    ``a``, ``kw``: slot and gid equal integer for integer."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    from svgir_tpu_torch.ops import binning_pallas as P

    ks, kg = (kernel or K.instances)(*a, **kw)
    ps, pg = P.instances_plain(*a, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ps) and torch.equal(kg, pg)):
        bad = int((ks != ps).sum() + (kg != pg).sum())
        raise AssertionError(f"B2 [{label}] instances kernel disagrees with "
                             f"its plain version at {bad} entries")
    return (f"{label}: {int(a[7])} instances of {kw['m']} slots, "
            f"{a[6].shape[0]} chunks x {a[6].shape[1]} tiles")


def instance_case(inp, dev):
    """B2's arguments on ``dev`` from a dict of
    ``tests/torch_kernel_inputs.instances_from_rects``."""
    import torch
    a = [torch.from_numpy(inp[k]).to(dev) for k in (
        "x0", "y0", "x1", "y1", "offsets", "order", "table")]
    a.append(torch.tensor(inp["total_raw"], dtype=torch.int32, device=dev))
    return a, dict(m=inp["m"], grid_x=inp["grid_x"], gauss_chunk=256)


def compare_binning(calls):
    """B1, B2 kernel vs plain on the captured inputs: integer equality."""
    compare_counts(*calls["compute_counts"], "captured")
    compare_instances(*calls["compute_instances"], "captured")


def compare_blend(calls, label):
    """B3, B4 kernel vs plain on the captured inputs; returns max errors.
    (The captured logT image is a saved autograd output: no_grad keeps the
    plain versions from recording a graph on it.)"""
    import torch

    with torch.no_grad():
        return _compare_blend(calls, label)


def check_image(ki, pi, nch, tag):
    """A blend image (kernel ``ki``) against its reference ``pi``, both
    [CA+CV+2, Hp, Wp]: channel sums within TOL_IMG, logT within 1e-5
    (TOL_LOGT_SAT where saturated), n_contrib at all but 1e-4 of the
    pixels; returns (max channel error, max logT error, n_contrib
    mismatches)."""
    from svgir_tpu_torch.ops.common import LOG_T_EPS

    err_img = float((ki[:nch] - pi[:nch]).abs().max()) if nch else 0.0
    lim = TOL_IMG * (1 + pi[:nch].abs())
    if not bool(((ki[:nch] - pi[:nch]).abs() <= lim).all()):
        raise AssertionError(f"{tag} channel sums differ by {err_img}")
    lt_k, lt_p = ki[nch], pi[nch]
    sat = lt_p < LOG_T_EPS
    err_lt = float((lt_k - lt_p).abs().max())
    if bool((lt_k - lt_p)[~sat].abs().max() > 1e-5) or \
            (bool(sat.any()) and
             bool((lt_k - lt_p)[sat].abs().max() > TOL_LOGT_SAT)):
        raise AssertionError(f"{tag} logT differs by {err_lt}")
    nc_bad = int((ki[nch + 1] != pi[nch + 1]).sum())
    if nc_bad > ki[nch + 1].numel() // 10000:
        raise AssertionError(f"{tag} n_contrib differs at {nc_bad} pixels")
    return err_img, err_lt, nc_bad


def check_rows(kd, pd, ca, tag):
    """Gradient rows d_slab against a reference, each row kind within
    TOL_ROWS of its largest magnitude; returns the max absolute error."""
    err = 0.0
    kinds = {"mean2d": slice(0, 2), "conic": slice(2, 5),
             "opacity": slice(5, 6), "jinv": slice(6, 10),
             "lam": slice(10, 12), "plain": slice(12, 12 + ca),
             "vertex": slice(12 + ca, None)}
    for kind, sl in kinds.items():
        if pd[:, sl].numel() == 0:
            continue
        e = max_err_rel(kd[:, sl], pd[:, sl])
        err = max(err, float((kd[:, sl] - pd[:, sl]).abs().max()))
        if e > TOL_ROWS:
            raise AssertionError(f"{tag} {kind} rows differ by {e} of their "
                                 "largest magnitude")
    return err


def _compare_blend(calls, label):
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas_strip as P

    a, kw = calls["blend_forward"]
    ki, ke, kwsum = K.blend_forward(*a, **kw)
    pi, pe, pwsum = P.blend_forward_plain(*a, **kw)
    torch.cuda.synchronize()
    ca, cv = kw["ca"], kw["cv"]
    if not torch.equal(ke, pe):
        raise AssertionError(f"B3 [{label}] eff differs: "
                             f"{int((ke != pe).sum())} tiles")
    err_img, err_lt, nc_bad = check_image(ki, pi, ca + cv, f"B3 [{label}]")
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
    err4 = check_rows(kd, pd, ca, f"B4 [{label}]")
    log(f"[kernels] {label}: B3 max|err| img {err_img:.3g} logT {err_lt:.3g} "
        f"wsum(rel) {err_w:.3g}; B4 max|err| {err4:.3g}; "
        f"n_contrib mismatches {nc_bad}")
    return err3, err4


def blend_edge_calls(inputs, name, tile, dev):
    """The blend's edge inputs (tests/torch_kernel_inputs.py) on the card
    as captured calls of B3/B4 and of B5/B6: the backward's eff, logT and
    meta from the plain forward, its cotangents from the inputs."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS

    d = inputs.blend_edge_inputs(name, tile=tile)
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()
         if hasattr(v, "shape")}
    kw = {k: d[k] for k in ("ca", "cv", "grid_x", "grid_y", "tile",
                            "chunk")}
    nch = d["ca"] + d["cv"]
    lay = dict(grid_x=d["grid_x"], grid_y=d["grid_y"], tile=tile)
    a = (t["slab"], t["tile_start"], t["tile_count"])
    with torch.no_grad():
        img, eff, _ = BS.blend_forward_plain(*a, **kw)
        out, _ = BP.blend_forward_plain(*a, **kw)
    g_out = torch.cat([BP.to_tiles(t["g_img"][:nch + 1], **lay),
                       torch.zeros_like(out[:, :2])], 1).contiguous()
    return {
        "blend_forward": (a, kw),
        "blend_backward": ((t["slab"], t["tile_start"], eff, t["g_img"],
                            img[nch].contiguous(), t["g_wsum"]), kw),
        "blend_forward_tiles": (a, kw),
        "blend_backward_tiles": ((t["slab"], t["tile_start"], g_out,
                                  out[:, nch:].contiguous(), t["g_wsum"]),
                                 kw)}


_PTXAS_KERNEL = re.compile(r"svgir_blend_(fwd|bwd)_kernelI((?:L[ib]\d+E)+)E")


def ptxas_blend(text):
    """Registers and spills of each blend instantiation in ``ptxas -v``
    output: {(direction, template arguments): {...}}, the arguments as
    mangled (ints and bools in order: for this tree MAXA, MAXV, EXACT,
    PPT, the backward's IB, ASYNC, TILES, then the backward's own)."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            m = _PTXAS_KERNEL.search(line)
            cur = None
            if m:
                args = tuple(int(x) for x in re.findall(r"L[ib](\d+)E", m[2]))
                cur = ("forward" if m[1] == "fwd" else "backward", args)
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


def blend_build(table, direction, ca, cv, tile, chunk, tiles=False):
    """The kernel a blend launch takes (its compiled widths, pixels per
    thread, instances per round, blocks per SM, threads, shared memory)
    with its registers and spills from the build log."""
    from svgir_tpu_torch.kernels import blend as K
    info = K.kernel_info(direction, ca=ca, cv=cv, tile=tile, chunk=chunk)
    at = 6 if direction == "backward" else 5       # TILES among the args
    for widths in ((ca, cv, 1), (16, 0, 0), (32, 16, 0)):
        for (d, args), v in table.items():
            if d == direction and args[:3] == widths and \
                    args[3] == info["ppt"] and args[at] == int(tiles):
                return {**info, "compiled_widths": f"{widths[0]}/{widths[1]}"
                        + ("" if widths[2] else " (generic)"), **v}
    raise AssertionError(f"no {direction} blend instantiation in the build "
                         f"log for {ca}/{cv}, tile {tile}")


def parent_kernels(parent_dir):
    """The blend, binning, column-copy, env-gradient (B7's backward) and
    march (B8) wrappers of another checkout
    (``parent_dir`` holds its ``svgir_tpu_torch``), imported from there
    with its own build module,
    which builds its kernels in ``parent_dir``: this tree's modules are set
    aside while the other's load, then put back.  Calls go through the
    other tree's own wrappers, so an interface that differs raises."""
    import importlib
    import os

    def ours():
        return {k: v for k, v in sys.modules.items()
                if k == "svgir_tpu_torch" or k.startswith("svgir_tpu_torch.")}
    mine = ours()
    for k in mine:
        del sys.modules[k]
    root = os.path.abspath(parent_dir)
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module("svgir_tpu_torch.kernels.blend")
        bin_ = importlib.import_module("svgir_tpu_torch.kernels.binning")
        cols = importlib.import_module("svgir_tpu_torch.kernels.cols")
        env = importlib.import_module("svgir_tpu_torch.kernels.env_lookup")
        march = importlib.import_module("svgir_tpu_torch.kernels.march")
        bld = importlib.import_module("svgir_tpu_torch.kernels.build")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    if not os.path.abspath(mod.__file__).startswith(root + os.sep):
        raise RuntimeError(f"--parent {parent_dir}: imported {mod.__file__}")
    bld.build()
    log_path = bld.BUILD_DIR / "build.log"
    return {"label": os.path.basename(os.path.normpath(parent_dir)),
            "blend_forward": mod.blend_forward,
            "blend_backward": mod.blend_backward,
            "blend_forward_tiles": mod.blend_forward_tiles,
            "blend_backward_tiles": mod.blend_backward_tiles,
            "counts": bin_.counts, "instances": bin_.instances,
            "pad_cols": cols.pad_cols, "slice_cols": cols.slice_cols,
            "env_lookup_backward": env.env_lookup_backward,
            "march": march.march,
            "ptxas": log_path.read_text() if log_path.exists() else ""}


def compare_parent(parent, calls, label, card, tiles=False):
    """Another tree's blend kernels (``parent_kernels``; B3/B4, or B5/B6 with
    ``tiles``) against this tree's on the captured inputs (held to each
    other at the kernel tolerances), then both timed in turns (other, this,
    this, other): per call and on the device.  Returns {"forward": {...},
    "backward": {...}}."""
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas as BP

    fwd, bwd = ("blend_forward_tiles", "blend_backward_tiles") if tiles \
        else ("blend_forward", "blend_backward")
    a, kw = calls[fwd]
    nch = kw["ca"] + kw["cv"]
    lay = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"], tile=kw["tile"])
    mine = {"blend_forward": K.blend_forward,
            "blend_backward": K.blend_backward,
            "blend_forward_tiles": K.blend_forward_tiles,
            "blend_backward_tiles": K.blend_backward_tiles}
    runs = {"forward": (lambda: parent[fwd](*a, **kw),
                        lambda: mine[fwd](*a, **kw))}
    with torch.no_grad():
        po, ko = parent[fwd](*a, **kw), mine[fwd](*a, **kw)
        torch.cuda.synchronize()
        if tiles:
            pi, ki = (BP.to_image(o[0][:, :nch + 2], **lay) for o in (po, ko))
            same_eff = torch.equal(po[0][:, nch + 2], ko[0][:, nch + 2])
        else:
            pi, ki, same_eff = po[0], ko[0], torch.equal(po[1], ko[1])
        if not same_eff:
            raise AssertionError(f"{fwd} [{label}]: chunks processed differ "
                                 "from the parent's")
        check_image(ki, pi, nch, f"{fwd} against the parent's [{label}]")
        if bwd in calls:
            b, bkw = calls[bwd]
            check_rows(mine[bwd](*b, **bkw), parent[bwd](*b, **bkw),
                       kw["ca"], f"{bwd} against the parent's [{label}]")
            runs["backward"] = (lambda: parent[bwd](*b, **bkw),
                                lambda: mine[bwd](*b, **bkw))
        out = {}
        for direction, (old, new) in runs.items():
            out[direction] = in_turns(old, new)
            log_turns(out[direction], f"{parent['label']} {label}: "
                      f"{direction}{' (tiles)' if tiles else ''}", card)
    return out


def parent_env_backward(parents, b, bkw, label, card):
    """Each other tree's B7 backward against this tree's on cotangents ``b``
    (within TOL_ENV_BWD of the largest |d_env|), then both timed in turns;
    returns {label: times}."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    out = {}
    for p in parents:
        with torch.no_grad():
            mine, theirs = K.env_lookup_backward(*b, **bkw), \
                p["env_lookup_backward"](*b, **bkw)
            torch.cuda.synchronize()
        e = float((mine - theirs).abs().max())
        if e > TOL_ENV_BWD * max(float(theirs.abs().max()), 1e-30):
            raise AssertionError(f"B7 backward [{label}] differs from "
                                 f"{p['label']}'s by {e}")
        o = in_turns(lambda p=p: p["env_lookup_backward"](*b, **bkw),
                     lambda: K.env_lookup_backward(*b, **bkw))
        out[p["label"]] = o
        log_turns(o, f"{p['label']} env_lookup_backward [{label}]", card)
    return out


def parent_march(parents, grid, o, d, mkw, label, card):
    """Each other tree's B8 against this tree's on one ray chunk (hit for
    hit, within MARCH_SLOT_TOL of the finite slots), then both timed in
    turns; returns {label: times}."""
    import torch

    from svgir_tpu_torch.kernels import march as K
    from svgir_tpu_torch.ops import grid_tracer as GT
    args = (grid.block_geo, grid.block_start, grid.cell_count, o, d)
    kw = dict(lo=grid.lo, inv_cell=grid.inv_cell, res=grid.res,
              dt=GT.grid_dt(grid), t_max=mkw["t_max"], n_steps=mkw["n_steps"],
              kmax=mkw["kmax"], cap=grid.cell_cap, k=mkw["k"])
    out = {}
    for p in parents:
        with torch.no_grad():
            (kt, ki), (pt, pi) = K.march(*args, **kw), p["march"](*args, **kw)
            torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        log(f"[parent] B8 [{label}] against {p['label']}'s: {int(fin.sum())} "
            f"finite slots, {bad} differ")
        if bad > MARCH_SLOT_TOL * max(int(fin.sum()), 1):
            raise AssertionError(f"B8 [{label}] differs from {p['label']}'s "
                                 f"at {bad} slots")
        o_ = in_turns(lambda p=p: p["march"](*args, **kw),
                      lambda: K.march(*args, **kw))
        out[p["label"]] = o_
        log_turns(o_, f"{p['label']} march [{label}]", card)
    return out


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


def bounds(calls, tiles=False):
    """Least time (ms) the card could take for each kernel's work on the
    captured inputs: max(bytes / HBM rate, operations / float32 rate), each
    input read once and each output written once.  The blend's work is
    counted on these inputs by the plain forward: the real rows of the
    chunks each tile processes, and their (pixel, row) pairs that are
    tested, pass the footprint test, and blend.  ``tiles``: the tile-major
    blend B5/B6 (keys ``blend_*_tiles``), whose output carries the chunks
    processed as one more row instead of B3's ``eff``; B6 reads the same
    bytes as B4 (cotangent rows, logT, one chunk count per tile).  The
    binning kernels and the backward are counted where they were
    captured."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas_strip as BS

    fwd, bwd = ("blend_forward_tiles", "blend_backward_tiles") if tiles \
        else ("blend_forward", "blend_backward")
    b3, kw3 = calls[fwd]
    slab, ts, tc = b3
    m, kr = slab.shape
    ca, cv = kw3["ca"], kw3["cv"]
    T = kw3["grid_x"] * kw3["grid_y"]
    hw = T * kw3["tile"] ** 2
    g_wsum = calls[bwd][0][-1] if bwd in calls else None   # last argument
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

    if "compute_counts" in calls:
        a, kw = calls["compute_counts"]
        ns = a[0].numel()
        nchunks = ns // kw.get("gauss_chunk", 256)
        a2, kw2 = calls["compute_instances"]
        total_raw = int(a2[7])
        bound("binning_counts", 16 * ns + 4 * T + 4 * nchunks * T, total_raw)
        bound("binning_instances", 24 * ns + 4 * nchunks * T + 8 * kw2["m"],
              total_raw * max(1, math.ceil(math.log2(ns))))
    rows_b = 4 * work["rows"] * kr               # real slab rows, read once
    out_b = 4 * (ca + cv + 3) * hw + 8 * T if tiles \
        else 4 * (ca + cv + 2) * hw + 12 * T
    bound(fwd, rows_b + out_b + (4 * m if kw3.get("emit_wsum", True) else 0),
          ops_fwd)
    bound(bwd, rows_b + 4 * (ca + cv + 2) * hw + 8 * T
          + (4 * m if g_wsum is not None else 0) + 4 * m * kr, ops_bwd)
    return out


def library_counts(calls):
    """One-call-per-stage PyTorch yardstick of the B1 counts alone (kept
    for continuity with earlier runs): corner bincount of the rect
    difference array, then a 2-D cumsum."""
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


def library_counts_carry(calls):
    """One-call-per-stage PyTorch yardstick of B1's whole function, counts
    and carry: a bincount of each Gaussian's four difference-array corners
    in its chunk's plane ([nchunks, gy+1, gx+1]; empty and inverted rects
    weigh 0), a 2-D cumsum per chunk, then an exclusive cumsum over the
    chunks.  Returns (counts [T], carry [nchunks, T]) int32."""
    import torch
    a, kw = calls["compute_counts"]
    gx, gy = kw["grid_x"], kw["grid_y"]
    gc = kw.get("gauss_chunk", 256)
    x0, y0 = a[0].long().clamp(0, gx), a[1].long().clamp(0, gy)
    x1, y1 = a[2].long().clamp(0, gx), a[3].long().clamp(0, gy)
    ns = x0.numel()
    nchunks, W = ns // gc, gx + 1
    plane = torch.arange(ns, device=x0.device) // gc * ((gy + 1) * W)

    def fn():
        live = ((x1 > x0) & (y1 > y0)).float()
        idx = torch.cat([plane + y0 * W + x0, plane + y0 * W + x1,
                         plane + y1 * W + x0, plane + y1 * W + x1])
        wts = torch.cat([live, -live, -live, live])
        d = torch.bincount(idx, weights=wts, minlength=nchunks * (gy + 1) * W)
        per = d.view(nchunks, gy + 1, W).cumsum(1).cumsum(2)[:, :gy, :gx]
        per = per.reshape(nchunks, gx * gy).to(torch.int32)
        inc = per.cumsum(0, dtype=torch.int32)
        return inc[-1], inc - per
    return fn


def profile_step(fn, out_dir, name="chip_smoke_profile.txt", steps=3):
    """torch.profiler table of ``steps`` train steps (after a warm-up),
    sorted by device time, written to ``out_dir/name``, with the device
    busy time per step counted by name as ``device_ms`` counts it."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    busy, ops, rec = device_by_name(prof, steps)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    head = (f"{steps} steps; device busy {busy:.3f} ms per step ({ops} "
            f"device operations, {rec:.3f} of them recorded)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(head + "\n" + table)
    log(f"[profile] {name}: {head}; by device time over the {steps} steps:")
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


def compare_env_forward(a, label):
    """B7 forward kernel vs plain on (env, u, v) ``a``: within
    TOL_ENV_FWD; returns the max absolute error."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    with torch.no_grad():
        kf, pf = K.env_lookup_forward(*a), P.env_lookup_forward_plain(*a)
        torch.cuda.synchronize()
    if kf.shape != pf.shape:
        raise AssertionError(f"B7 [{label}] forward of shape "
                             f"{tuple(kf.shape)}, not {tuple(pf.shape)}")
    ef = float((kf - pf).abs().max()) if pf.numel() else 0.0
    if ef > TOL_ENV_FWD:
        raise AssertionError(f"B7 [{label}] forward differs by {ef}")
    return ef


def compare_env(calls, label):
    """B7 forward and backward kernel vs plain on the captured inputs;
    returns the max absolute errors."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    a, _ = calls["env_lookup_forward"]
    ef = compare_env_forward(a, label)
    with torch.no_grad():
        b, bkw = calls["env_lookup_backward"]
        kb = K.env_lookup_backward(*b, **bkw)
        pb = P.env_lookup_backward_plain(*b, **bkw)
        torch.cuda.synchronize()
    eb = float((kb - pb).abs().max())
    scale = max(float(pb.abs().max()), 1e-30)
    log(f"[kernels] {label}: B7 forward max|err| {ef:.3g} over "
        f"{a[1].numel()} queries; backward max|err| {eb:.3g} "
        f"({eb / scale:.3g} of max |d_env| {scale:.4g})")
    if eb > TOL_ENV_BWD * scale:
        raise AssertionError(f"B7 [{label}] backward differs by {eb}")
    return ef, eb


def compare_env_backward(u, v, g, h, w, label):
    """B7 backward kernel vs plain on queries u, v and cotangents g into an
    h x w env: within TOL_ENV_BWD of the largest |d_env|; returns the max
    absolute error."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    with torch.no_grad():
        kb = K.env_lookup_backward(u, v, g, h=h, w=w)
        pb = P.env_lookup_backward_plain(u, v, g, h=h, w=w)
        torch.cuda.synchronize()
    eb = float((kb - pb).abs().max())
    if eb > TOL_ENV_BWD * max(float(pb.abs().max()), 1e-30):
        raise AssertionError(f"B7 [{label}] backward differs by {eb}")
    return eb


# Float operations of B7 per query: each of the two coordinates' taps
# (floor, two clamps of the floor, subtract, two clamps of the fraction,
# convert, compare-select: 8), the two complements (2); per channel the
# forward's three lerps (3 each), the backward's two tap weights and four
# weighted adds into d_env (10).
ENV_TAP_OPS = 18


def env_bounds(a):
    """Least time (ms) of B7's forward and backward on the forward's
    arguments ``a`` (env, u, v): each query's u, v read once, its samples
    (forward) or cotangents (backward) once, the env read (forward) or
    d_env written (backward) once."""
    h, w, c = a[0].shape
    m = a[1].numel()
    nb = 4 * (2 * m + m * c + h * w * c)
    out = {}
    for name, ops in (("env_lookup_forward", m * (ENV_TAP_OPS + 9 * c)),
                      ("env_lookup_backward", m * (ENV_TAP_OPS + 10 * c))):
        tb, to = nb / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def _grid_sample_args(a):
    import torch
    env, u, v = a
    h, w = env.shape[:2]
    envt = env.detach().permute(2, 0, 1)[None].contiguous()   # [1, C, H, W]
    grid = torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1],
                       -1)[None, None]                           # [1, 1, M, 2]
    return envt, grid


def library_env_forward(a):
    """One-call PyTorch yardstick of B7's forward on (env, u, v) ``a``:
    grid_sample(align_corners=True) on the same env and coordinates."""
    import torch.nn.functional as F
    envt, grid = _grid_sample_args(a)
    return lambda: F.grid_sample(envt, grid, mode="bilinear",
                                 align_corners=True)


def library_env_backward(calls):
    """One-call PyTorch yardstick of B7's backward: grid_sample's env
    gradient alone, on the step's coordinates and cotangents."""
    import torch
    envt, grid = _grid_sample_args(calls["env_lookup_forward"][0])
    g = calls["env_lookup_backward"][0][2]
    gout = g.t().contiguous()[None, :, None, :]                  # [1, C, 1, M]
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, envt, grid, 0, 0, True, [True, False])


def small_stage2(device, n=2000, res=96, samples=8, seed=3, env_h=16):
    """A small stage-2 scene on ``device``, made on the CPU from a seeded
    generator: surfels on a sphere facing a close camera, random PBR
    parameters, a synthetic bake and an env_h x 2 env_h env."""
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
                                     env_h=env_h, seed=seed)
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


def run_small_stage2(device, env_h=16):
    """The small stage-2 scene's eval images, train-mode loss and
    gradients (every parameter group and the env) on ``device``."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.render.svgss import render_svgss, render_view_svgss

    state, bake, env, cam = small_stage2(device, env_h=env_h)
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


# ---------------------------------------------------------------------------
# the radiance bake
# ---------------------------------------------------------------------------

BAKE_SAMPLES = 64       # train_stage2's sample_num (--sample_num 64)
BAKE_ENV_H = 32         # the recipe's --env_resolution 32 (train_stage2's
                        # and the configuration's default is 16)
# Float operations of B8 (csrc/march.cu), an exp or division counting one:
# a candidate test (the plane hit, its local uv and ellipse metric, the
# power's six products and sums, alpha and the eight acceptance tests with
# their conjunction) and a step of the cell walk (the midpoint and the
# three clamped cell coordinates).  The merge's inserts are not counted.
MARCH_TEST_OPS = 84
MARCH_STEP_OPS = 33


class Recorder:
    """Wraps ``mod.name`` while open: records each call's arguments,
    result and wall seconds (synchronized on both sides)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.calls = mod, name, []

    def __enter__(self):
        import torch
        self.fn = getattr(self.mod, self.name)

        def rec(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((a, kw, out, time.perf_counter() - t0))
            return out
        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def march_work(grid, o, d, t, *, n_steps, kmax, k):
    """The work B8's function needs on rays (o, d) whose result is t
    [R, k]: the visits before the walk may stop (a full list whose k-th t
    lies at or before the visit's start: nothing later can enter), the
    steps walked to there, and the distinct blocks and cells those visits
    read."""
    import torch

    from svgir_tpu_torch.ops import grid_tracer as GT
    nb, _, cells = GT._run_scan(grid, o, d, n_steps=n_steps, kmax=kmax)
    j = torch.arange(n_steps, device=o.device)
    t_lo = j.to(torch.float32) * GT.grid_dt(grid)
    kth = torch.where(torch.isfinite(t[:, k - 1]), t[:, k - 1],
                      torch.full_like(t[:, 0], float("inf")))
    late = (nb > 0) & ~(t_lo[None] < kth[:, None])
    stop = torch.where(late.any(1), late.to(torch.int32).argmax(1),
                       torch.full_like(j[:1], n_steps).expand(len(o)))
    needed = (nb > 0) & (j[None] < stop[:, None])
    cells_u = torch.unique(cells[needed])
    cnt = torch.clamp(grid.cell_count[cells_u.long()], max=grid.cell_cap)
    return {"blocks": int((nb * needed).sum()), "all_blocks": int(nb.sum()),
            "steps": int(stop.sum()), "cells": int(cells_u.numel()),
            "distinct_blocks": int(((cnt + 63) // 64).sum())}


def march_bound(work, r, k):
    """Least time (ms) of B8 on ``work``: the 24 fields the test reads of
    each distinct block (6 KB) and its cell's two entries read once, each
    ray's 24 bytes read and its k hits (8 bytes each) written once; the
    needed candidate tests and walk steps at the float32 rate."""
    nbytes = work["distinct_blocks"] * 24 * 64 * 4 + work["cells"] * 8 \
        + r * (24 + 8 * k)
    ops = work["blocks"] * 64 * MARCH_TEST_OPS + work["steps"] * MARCH_STEP_OPS
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def small_bake_inputs(n=3000, seed=5):
    """bake_radiance inputs of a small scene made on the CPU from a seeded
    generator: surfels on a thin ball shell facing its centre (normals
    more than 60 degrees from -z, where rotation_between_z divides by
    1 + n_z), SH colours, and the spirals' azimuth draws."""
    import torch

    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator().manual_seed(seed)
    d = normalize(torch.randn(2 * n, 3, generator=g))
    d = d[d[:, 2] < 0.5][:n]
    pts = d * (0.3 + 0.05 * torch.rand(len(d), 1, generator=g))
    st = G.init_from_points(pts, torch.rand(len(d), 3, generator=g),
                            normals=-d, capacity=len(d),
                            rotation_init="normal", device="cpu")
    p = st["params"]
    shs = 0.3 * torch.randn(len(d), 16, 3, generator=g)
    az = torch.rand(len(d), 1, generator=g)
    return (p["xyz"], G.get_scaling(p), G.get_rotation(p),
            G.get_opacity(p)[:, 0], shs), az


def run_bake(state, cam, opt, cfg, bg, card, dev, parents=(),
             profile_dir=None):
    """Phases 12-16; returns B8's entries of the kernels JSON (the main
    path's first chunk, and the inward bench bake's).  With
    ``profile_dir``, also writes the profile of one S = 64 step there;
    with ``parents``, times their B7 backward and B8 in turns."""
    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.ops import tracing as TR
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import optim, trainer

    # ---- 12. bake + train: train_stage2(bake=None) (main path) ----------
    pbr = G.upgrade_to_pbr(state)
    steps = 3
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Recorder(trainer, "bake_radiance_compact") as rc, \
            Recorder(GT, "nearest_hits_grid") as rg:
        st3, _, env3, bake3, hist3 = trainer.train_stage2(
            pbr, [cam], opt, raster_cfg=cfg, sample_num=BAKE_SAMPLES,
            env_resolution=BAKE_ENV_H, first_iter=30_000,
            iterations=30_000 + steps, log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    peak_all = torch.cuda.max_memory_allocated()
    (_, bkw, bake_out, bake_s), = rc.calls
    exhausted = float(bake_out["exhausted_frac"])
    hits = bake3["hit_idx"]
    log(f"[bake+train] train_stage2(bake=None), {int(state['alive'].sum())} "
        f"surfels x S={BAKE_SAMPLES}: bake {bake_s:.3f} s (cold: kernel load, grid "
        f"build, {len(rg.calls)} ray chunks whose grid tracing took "
        f"{sum(c[3] for c in rg.calls):.3f} s), exhausted_frac {exhausted:.6f},"
        f" rays with a first hit {float((hits >= 0).float().mean()):.4f}, "
        f"mean visibility {float(bake3['visibility'].mean()):.4f}; "
        f"{steps} steps: " + ", ".join(
            f"loss {h['loss']:.6f} psnr_pbr {h['psnr_pbr']:.4f}"
            for h in hist3) + f"; wall {wall:.3f} s, peak memory "
        f"{peak_all / 2**30:.3f} GiB; card: {card}")
    log(f"[bake+train] launches {launches}")
    if launches["march"] < 1:
        raise AssertionError("the bake did not launch the march kernel")
    for k in STAGE2_KERNELS:
        if launches[k] < steps:
            raise AssertionError(f"bake+train launched {k} {launches[k]} "
                                 f"times in {steps} steps")
    if tuple(hits.shape) != (state["alive"].shape[0], BAKE_SAMPLES):
        raise AssertionError(f"bake: hit_idx of shape {tuple(hits.shape)}")
    for k in ("radiance", "visibility", "uv", "incident_qxy"):
        if not bool(torch.isfinite(bake3[k]).all()):
            raise AssertionError(f"bake: non-finite {k}")
    if any(not math.isfinite(h["loss"]) or h.get("overflow")
           for h in hist3):
        raise AssertionError(f"bake+train: bad step {hist3}")
    for k, v in list(st3["params"].items()) + \
            [("env", env3["params"]["env"]),
             ("env m", env3["opt"]["m"]["env"]),
             ("env v", env3["opt"]["v"]["env"])]:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"bake+train: non-finite values in {k}")

    step3 = trainer.make_svgss_train_step(
        opt, cfg, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    s3_args = (st3, optim.adam_init(st3["params"]), env3, bake3, cam, 1.0,
               1e-5, opt.radiance_lr)
    step3(*s3_args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step3(*s3_args)
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated()
    step_ms = host_ms(lambda: step3(*s3_args), reps=5, warmup=1)
    log(f"[bake+train] S={BAKE_SAMPLES} stage-2 train step {step_ms:.3f} ms"
        f" (median of 5), peak memory {peak_step / 2**30:.3f} GiB "
        f"(max_memory_allocated); card: {card}")
    if profile_dir:
        profile_step(lambda: step3(*s3_args), profile_dir,
                     "chip_smoke_profile_stage2_s64.txt")
    # B7 at the recipe's shape: the S = 64 step's lookups on its env
    with Capture() as cap64:
        step3(*s3_args)
    torch.cuda.synchronize()
    c64 = cap64.calls
    env_label = (f"S = {BAKE_SAMPLES} step, env {BAKE_ENV_H}x"
                 f"{2 * BAKE_ENV_H}")
    e7 = compare_env(c64, env_label)
    fa64, _ = c64["env_lookup_forward"]
    ba64, bkw64 = c64["env_lookup_backward"]
    bnd64 = env_bounds(fa64)
    b7_entries = []
    for i, (name, kfn, pfn, lfn) in enumerate((
            ("env_lookup_forward", lambda: KE.env_lookup_forward(*fa64),
             lambda: EP.env_lookup_forward_plain(*fa64),
             library_env_forward(fa64)),
            ("env_lookup_backward",
             lambda: KE.env_lookup_backward(*ba64, **bkw64),
             lambda: EP.env_lookup_backward_plain(*ba64, **bkw64),
             library_env_backward(c64)))):
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        bd = bnd64[name]
        b7_entries.append({
            "name": f"{name}_s64", "route": "cuda",
            "source": "svgir_tpu_torch/csrc/env_lookup.cu",
            "replaces": "svgir_tpu/ops/env_lookup_pallas.py:"
            + ("63" if i == 0 else "76"), "launches": launches[name],
            "max_abs_err": e7[i], **t, "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[bake timing] {name} at the recipe's shape ({env_label}, "
            f"{fa64[1].numel()} queries): " + fmt_times(t, "grid_sample")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; {launches[name]} "
            f"launches in the bake and {steps} steps; card: {card}")
    times = parent_env_backward(parents, ba64, bkw64, env_label, card)
    if times:
        b7_entries[1]["parent"] = times

    # ---- the bench scene turned inward: a full-size bake whose rays hit --
    # The main path's surfels face outward, so none of its rays meets a
    # front face.  The same 50,000 surfels facing the centre, baked at
    # S = 64 and k 16, give B8 (13), the oracle (14) and the timings (16)
    # chunks of the main path's size and grid size in which lists fill.
    in_state, _ = bench_scene(dev, inward=True)
    p_in = in_state["params"]
    in_inputs = (p_in["xyz"], G.get_scaling(p_in), G.get_rotation(p_in),
                 G.get_opacity(p_in)[:, 0], G.get_shs(p_in))
    in_kw = dict(sample_num=BAKE_SAMPLES, k_hits=16, azimuth=torch.rand(
        p_in["xyz"].shape[0], 1, device=dev,
        generator=torch.Generator(device=dev).manual_seed(7)))
    with Recorder(GT, "nearest_hits_grid") as ri:
        b_in = RAD.bake_radiance(*in_inputs, **in_kw)
    in_hit = float((b_in["hit_idx"] >= 0).float().mean())
    log(f"[inward] the bench surfels facing inward, bake_radiance at S="
        f"{BAKE_SAMPLES}, k 16: {len(ri.calls)} ray chunks, rays with a "
        f"first hit {in_hit:.4f}, exhausted_frac "
        f"{float(b_in['exhausted_frac']):.6f}, mean visibility "
        f"{float(b_in['visibility'].mean()):.4f}")
    if in_hit == 0.0:
        raise AssertionError("inward bake: no ray has a first hit")
    for key in ("radiance", "visibility", "uv"):
        if not bool(torch.isfinite(b_in[key]).all()):
            raise AssertionError(f"inward bake: non-finite {key}")
    # one S = 64 step on this bake (hit rows spread over the surfels)
    bake_in = {x: v for x, v in b_in.items() if x != "exhausted_frac"}
    st_in = G.upgrade_to_pbr(in_state)
    prm = dict(st_in["params"])
    prm["radiances"] = bake_in["radiance"].clone()
    prm["radiance_ratio"] = torch.ones((), device=dev)
    st_in = {**st_in, "params": prm, "stats": in_state["stats"]}
    in_args = (st_in, optim.adam_init(prm), env3, bake_in, cam, 1.0, 1e-5,
               opt.radiance_lr)
    # the inward surfels cover more tiles: the cap is sized from their own
    # forward render as phase 2 sizes the main path's
    with torch.no_grad(), Capture() as cap_in:
        render_view_stage1(cam, p_in, bg, alive=in_state["alive"],
                           cfg=RasterConfig())
    padded_in = int(cap_in.calls["blend_forward"][0][2].sum())
    cfg_in = RasterConfig(max_instances=-(-padded_in * 21 // (20 * 2048))
                          * 2048)
    step_in = trainer.make_svgss_train_step(
        opt, cfg_in, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    tb_in = step_in(*in_args)[3]
    if not math.isfinite(float(tb_in["loss"])) or bool(tb_in["overflow"]):
        raise AssertionError(f"inward S={BAKE_SAMPLES} step: loss "
                             f"{float(tb_in['loss'])}, overflow "
                             f"{bool(tb_in['overflow'])}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_in(*in_args)
    torch.cuda.synchronize()
    peak_in = torch.cuda.max_memory_allocated()
    step_in_ms = host_ms(lambda: step_in(*in_args), reps=5, warmup=1)
    log(f"[inward] S={BAKE_SAMPLES} stage-2 train step on the inward bake "
        f"{step_in_ms:.3f} ms at cap {cfg_in.max_instances} ({padded_in} "
        f"padded instances; median of 5; the main path's bake: "
        f"{step_ms:.3f} ms at cap {cfg.max_instances}), peak memory "
        f"{peak_in / 2**30:.3f} GiB; card: {card}")
    if profile_dir:
        profile_step(lambda: step_in(*in_args), profile_dir,
                     "chip_smoke_profile_stage2_s64_inward.txt")

    # ---- 13. B8 against its plain version ---------------------------------
    # on the first ray chunk of the main path's bake (no hits), of the
    # inward bake (lists fill and merge at full size), and on a small
    # bake's rays (surfels facing inward) at every k the kernel takes
    (geo, grid, o, d), hkw, _, _ = rg.calls[0]
    k = hkw["k"]
    mkw = dict(t_max=hkw["t_max"], k=k, n_steps=hkw["n_steps"],
               kmax=GT._run_kmax(grid))
    (geo_i, grid_i, o_i, d_i), ikw, _, _ = ri.calls[0]
    imkw = dict(t_max=ikw["t_max"], k=ikw["k"], n_steps=ikw["n_steps"],
                kmax=GT._run_kmax(grid_i))
    inputs, az = small_bake_inputs()
    kw = dict(sample_num=16, use_grid=True)
    with Recorder(GT, "nearest_hits_grid") as rs:
        b_dev = RAD.bake_radiance(*[x.to(dev) for x in inputs],
                                  azimuth=az.to(dev), **kw)
    (_, grid_s, o_s, d_s), skw, _, _ = rs.calls[0]
    smkw = dict(t_max=skw["t_max"], k=skw["k"], n_steps=skw["n_steps"],
                kmax=GT._run_kmax(grid_s))
    cases = {"bench chunk": (grid, o, d, mkw),
             "inward bench chunk": (grid_i, o_i, d_i, imkw),
             "small bake": (grid_s, o_s, d_s, smkw)}
    # the kernel's other register layouts and the re-bake's doubled k
    for kk in (8, 32, 64, 128):
        cases[f"small bake, k {kk}"] = (grid_s, o_s[:8192], d_s[:8192],
                                        {**smkw, "k": kk})
    err, err_i = 0.0, 0.0
    for label, (g_, o_, d_, kw_) in cases.items():
        with torch.no_grad():
            kt, ki = MP.march(g_, o_, d_, **kw_)
            pt, pi = MP.march_plain(g_, o_, d_, **kw_)
        torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        n_fin = int(fin.sum())
        both = fin & torch.isfinite(kt)
        e = float((kt - pt)[both].abs().max()) if bool(both.any()) else 0.0
        err = max(err, e)
        log(f"[march] B8 vs plain, {label}: {len(o_)} rays (grid res "
            f"{g_.res}, cap {g_.cell_cap}, {g_.block_geo.shape[0] - 1} "
            f"blocks, {g_.big_ids.shape[0]} big surfels, n_steps "
            f"{kw_['n_steps']}, kmax {kw_['kmax']}, k {kw_['k']}): {n_fin} "
            f"finite slots, {int(fin[:, -1].sum())} full lists, {bad} slots"
            f" differ, max|t err| {e:.3g}")
        if bad > MARCH_SLOT_TOL * max(n_fin, 1):
            raise AssertionError(f"B8 differs from its plain version at "
                                 f"{bad} of {n_fin} finite slots")
        if label == "bench chunk":
            bench_t = pt
        elif label == "inward bench chunk":
            in_t, err_i = pt, e
            if n_fin < 0.25 * pt.numel():
                raise AssertionError(f"the inward chunk has only {n_fin} "
                                     "finite slots")
        elif label == "small bake":
            small_t = pt

    # ---- 14. the grid march (B8) against the brute oracle ---------------
    # on the 4,096 rays with the most hits of the bench chunk, the inward
    # bench chunk and the small bake (the main path's bench surfels face
    # outward: their rays meet only back faces, which the hit test rejects)
    geo_s = TR.build_surfel_geometry(*[x.to(dev) for x in inputs[:4]])
    for label, (geo_, g_, o_, d_, kw_, t_) in {
            "bench chunk": (geo, grid, o, d, hkw, bench_t),
            "inward bench chunk": (geo_i, grid_i, o_i, d_i, ikw, in_t),
            "small bake": (geo_s, grid_s, o_s, d_s, skw, small_t)}.items():
        sel = torch.argsort(torch.isfinite(t_).sum(1), descending=True,
                            stable=True)[:4096]
        with torch.no_grad():
            hg = GT.nearest_hits_grid(geo_, g_, o_[sel], d_[sel],
                                      t_max=kw_["t_max"], k=kw_["k"],
                                      n_steps=kw_["n_steps"])
            hb = TR.nearest_hits(geo_, o_[sel], d_[sel], k=kw_["k"])
        torch.cuda.synchronize()
        fb = torch.isfinite(hb["t"])
        bad_o = int(((fb != torch.isfinite(hg["t"]))
                     | (fb & ((hg["idx"] != hb["idx"])
                              | (hg["t"] != hb["t"])))).sum())
        log(f"[oracle] grid march (B8) vs brute, {label}, 4096 rays: "
            f"{int(fb.sum())} finite slots, {bad_o} differ")
        if label != "bench chunk" and not bool(fb.any()):
            raise AssertionError(f"oracle: no hits on the {label}")
        if bad_o > MARCH_SLOT_TOL * max(int(fb.sum()), 1):
            raise AssertionError(f"grid march differs from brute at {bad_o}"
                                 f" slots ({label})")

    # ---- 15. the small bake on the card against the CPU's plain path ----
    # a ray differs when its first hit does or its radiance, visibility or
    # uv is off by more than BAKE_VAL_TOL (a later hit can flip at an
    # acceptance boundary between the devices' roundings)
    b_cpu = RAD.bake_radiance(*inputs, azimuth=az, **kw)
    off = b_dev["hit_idx"].cpu() != b_cpu["hit_idx"]
    for key in ("radiance", "visibility", "uv"):
        off |= ((b_dev[key].cpu() - b_cpu[key]).abs()
                > BAKE_VAL_TOL).any(-1)
    n_rays = off.numel()
    worst = max(float((b_dev[key].cpu() - b_cpu[key]).abs()[~off].max())
                for key in ("radiance", "visibility", "uv"))
    log(f"[bake parity] {inputs[0].shape[0]} surfels x 16: card vs CPU "
        f"differ on {int(off.sum())} of {n_rays} rays "
        f"({int((b_cpu['hit_idx'] >= 0).sum())} with a first hit); the "
        f"others within {worst:.3g}")
    if int(off.sum()) > BAKE_HIT_TOL * n_rays:
        raise AssertionError("bake parity: card and CPU bakes differ")

    # ---- 16. timing ------------------------------------------------------
    params, alive = rc.calls[0][0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.bake_radiance_compact(params, alive, **bkw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    per_bake = kernels.launches()["march"]
    if profile_dir:
        profile_step(lambda: trainer.bake_radiance_compact(params, alive,
                                                           **bkw),
                     profile_dir, "chip_smoke_profile_bake.txt", steps=1)
    with torch.no_grad():
        tb = timings(lambda: MP.march(grid, o, d, **mkw),
                     lambda: MP.march_plain(grid, o, d, **mkw), reps=10,
                     plain_reps=2)
    work = march_work(grid, o, d, bench_t, **{x: mkw[x] for x in
                                              ("n_steps", "kmax", "k")})
    bms, by = march_bound(work, len(o), k)
    log(f"[bake timing] warm bake {warm_s:.3f} s ({per_bake} B8 launches, "
        f"{len(o)} rays each but the last); B8 {fmt_times(tb)}, bound "
        f"{bms:.4f} ms by {by}; the chunk's "
        f"rays visit {work['all_blocks']} blocks, {work['blocks']} before "
        f"their lists are settled, {work['distinct_blocks']} distinct; "
        f"card: {card}")
    # the inward bench bake: warm, and B8 on its first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RAD.bake_radiance(*in_inputs, **in_kw)
    torch.cuda.synchronize()
    warm_in_s = time.perf_counter() - t0
    with torch.no_grad():
        tb_i = timings(lambda: MP.march(grid_i, o_i, d_i, **imkw),
                       lambda: MP.march_plain(grid_i, o_i, d_i, **imkw),
                       reps=10, plain_reps=2)
    work_i = march_work(grid_i, o_i, d_i, in_t,
                        **{x: imkw[x] for x in ("n_steps", "kmax", "k")})
    bms_i, by_i = march_bound(work_i, len(o_i), imkw["k"])
    log(f"[bake timing] inward bench bake (k 16): warm {warm_in_s:.3f} s; "
        f"B8 on its first chunk {fmt_times(tb_i)}, bound "
        f"{bms_i:.4f} ms by {by_i}; the chunk's rays visit "
        f"{work_i['all_blocks']} blocks, {work_i['blocks']} before their "
        f"lists are settled, {work_i['distinct_blocks']} distinct; grid res "
        f"{grid_i.res}, cap {grid_i.cell_cap}; card: {card}")
    # the brute and the grid tracer on each side of bake_radiance's switch
    # (the grid from 4,096 surfels)
    for n_s, seed in ((3000, 5), (6000, 6)):
        inp, az_s = small_bake_inputs(n=n_s, seed=seed)
        inp, az_s = [x.to(dev) for x in inp], az_s.to(dev)
        t_b = {ug: host_ms(lambda: RAD.bake_radiance(
            *inp, azimuth=az_s, sample_num=BAKE_SAMPLES, use_grid=ug),
            reps=3, warmup=1) for ug in (False, True)}
        log(f"[bake timing] bake_radiance of {inp[0].shape[0]} inward "
            f"surfels x S={BAKE_SAMPLES}: brute {t_b[False]:.3f} ms, grid "
            f"{t_b[True]:.3f} ms (median of 3, warm); card: {card}")
    entry = {"route": "cuda", "source": "svgir_tpu_torch/csrc/march.cu",
             "replaces": "svgir_tpu/ops/march_pallas.py:66",
             "launches": launches["march"]}
    b8 = [{"name": "march", **entry, "max_abs_err": err, **tb,
           "bound_ms": bms, "bound_by": by},
          {"name": "march_inward_bench", **entry, "max_abs_err": err_i,
           **tb_i, "bound_ms": bms_i, "bound_by": by_i}]
    # B8 against each --parent tree's, in turns, on both chunks
    for e, (g_, o_, d_, kw_, label) in zip(b8, (
            (grid, o, d, mkw, "no-hit chunk"),
            (grid_i, o_i, d_i, imkw, "inward chunk"))):
        times = parent_march(parents, g_, o_, d_, kw_, label, card)
        if times:
            e["parent"] = times
    return b8 + b7_entries


# ---------------------------------------------------------------------------
# the tile-major paths: strip 0 and the sort binner (B5, B6), and B9
# ---------------------------------------------------------------------------

# The port's dense oracle against its tiled paths on the card: the oracle
# walks the Gaussians in depth-ordered batches, the kernels per pixel in
# order, so sums differ by float32 rounding; past saturation the oracle's
# logT keeps falling where a tile stops at its exit chunk (ROADMAP C-7), so
# T (below 1e-4 there) and the images through it differ by up to 1e-4 of the
# background; n_contrib may flip where logT crosses the 1e-4 gate at another
# instance.
TOL_DENSE_IMG = 2e-4    # absolute
TOL_DENSE_REL = 1e-3    # depth (where opacity > 0.05) and weights, of max
TOL_DENSE_NC = 1e-3     # share of pixels whose n_contrib may differ
B9_KOUT = 128           # the reference's lane width: stage-1 KR -> 128


def compare_tiles(calls, label):
    """B5/B6 kernel vs plain on the captured inputs, and against B3/B4 on
    the same inputs: B5's output assembled to image layout against B3's
    image and eff, B6's rows against B4's on the same cotangents and logT
    re-laid as images.  Returns (B5 max error, B6 max error or None)."""
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas as BP

    with torch.no_grad():
        a, kw = calls["blend_forward_tiles"]
        ca, cv = kw["ca"], kw["cv"]
        nch = ca + cv
        lay = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"], tile=kw["tile"])
        ko, kws = K.blend_forward_tiles(*a, **kw)
        po, pws = BP.blend_forward_plain(*a, **kw)
        bi, be, bws = K.blend_forward(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ko[:, nch + 2], po[:, nch + 2]):
            raise AssertionError(f"B5 [{label}] chunks processed differ from "
                                 "the plain version's")
        ki = BP.to_image(ko[:, :nch + 2], **lay)
        e_img, e_lt, nc_bad = check_image(
            ki, BP.to_image(po[:, :nch + 2], **lay), nch, f"B5 [{label}]")
        err_w = 0.0
        if kws is not None:
            err_w = max_err_rel(kws, pws)
            if err_w > TOL_ROWS or max_err_rel(kws, bws) > TOL_ROWS:
                raise AssertionError(f"B5 [{label}] weight sums differ: "
                                     f"{err_w}")
        if not torch.equal(ko[:, nch + 2, 0].to(torch.int32), be):
            raise AssertionError(f"B5 [{label}] chunks processed differ from "
                                 "B3's eff")
        x_img, x_lt, _ = check_image(ki, bi, nch, f"B5 vs B3 [{label}]")
        if not torch.equal(ki, bi) or (kws is not None and
                                       not torch.equal(kws, bws)):
            raise AssertionError(f"B5 [{label}] is not bit-equal to B3")
        msg = (f"[kernels] {label}: B5 max|err| img {e_img:.3g} logT "
               f"{e_lt:.3g} wsum(rel) {err_w:.3g}, n_contrib mismatches "
               f"{nc_bad}; assembled against B3: img {x_img:.3g} logT "
               f"{x_lt:.3g}, eff equal, bit-equal")
        err5 = max(e_img, e_lt, err_w)
        if "blend_backward_tiles" not in calls:      # a forward-only render
            log(msg)
            return err5, None
        b, bkw = calls["blend_backward_tiles"]
        kd = K.blend_backward_tiles(*b, **bkw)
        pd = BP.blend_backward_plain(*b, **bkw)
        slab, ts, g_out, meta, g_wsum = b
        d4 = K.blend_backward(
            slab, ts, meta[:, 2, 0].to(torch.int32).contiguous(),
            BP.to_image(g_out[:, :nch + 1], **lay).contiguous(),
            BP.to_image(meta[:, :1], **lay)[0].contiguous(), g_wsum, **bkw)
        torch.cuda.synchronize()
    err6 = check_rows(kd, pd, ca, f"B6 [{label}]")
    x6 = check_rows(kd, d4, ca, f"B6 vs B4 [{label}]")
    if not torch.equal(kd, d4):
        raise AssertionError(f"B6 [{label}] is not bit-equal to B4")
    log(msg + f"; B6 max|err| {err6:.3g}, against B4 {x6:.3g}")
    return err5, err6


def check_launches(launches, label, *, at_least=(), none=()):
    """Raise unless each kernel of ``at_least`` ((name, count) pairs) was
    launched that often and none of ``none`` was launched."""
    for k, n in at_least:
        if launches[k] < n:
            raise AssertionError(f"{label} launched {k} {launches[k]} times, "
                                 f"expected at least {n}")
    for k in none:
        if launches[k]:
            raise AssertionError(f"{label} launched {k} {launches[k]} times "
                                 "(another path than the one asked for)")


def run_tiles(state, cam, opt, cfg, bg, card, dev, *, step8, s2,
              edge_calls, ptx, parents, profile_dir=None):
    """Phases 17-23; returns the kernels JSON entries of B5, B6 and B9.
    ``step8`` is the strip-8 stage-1 step with its arguments, ``s2`` the
    stage-2 inputs with the strip-8 stage-2 step and its arguments."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.kernels import blend as KBL
    from svgir_tpu_torch.kernels import cols as KC
    from svgir_tpu_torch.ops import binning as BN
    from svgir_tpu_torch.ops import blend_pallas as BP
    from svgir_tpu_torch.ops.dense_ref import render_dense
    from svgir_tpu_torch.ops.preprocess import preprocess
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.render.svgss import render_view_svgss
    from svgir_tpu_torch.train import optim, trainer

    cfg0 = dataclasses.replace(cfg, strip=0)
    strip_kernels = ("blend_forward", "blend_backward")
    steps = 5
    t_tiles = time.time()

    # ---- 17. strip-0 train: train_stage1 with RasterConfig(strip=0) ------
    torch.cuda.synchronize()
    kernels.reset_launches()
    st, ost, hist = trainer.train_stage1(
        state, [cam], opt, raster_cfg=cfg0, iterations=steps, log_every=1,
        device=dev)
    torch.cuda.synchronize()
    l17 = kernels.launches()
    log(f"[strip0 train] {steps} steps at cap {cfg0.max_instances}: " +
        ", ".join(f"it {h['iter']} loss {h['loss']:.6f} psnr {h['psnr']:.4f}"
                  for h in hist))
    log(f"[strip0 train] launches {l17}")
    for h in hist:
        if not math.isfinite(h["loss"]) or h.get("overflow"):
            raise AssertionError(f"strip-0 train: bad step {h}")
    for k, v in list(st["params"].items()) + list(ost["m"].items()) + \
            list(ost["v"].items()):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"strip-0 train: non-finite values in {k}")
    check_launches(l17, "strip-0 train", at_least=(
        ("binning_counts", 1), ("binning_instances", 1),
        ("blend_forward_tiles", steps), ("blend_backward_tiles", steps)),
        none=strip_kernels)

    # ---- 18. strip-0 kernels: B5/B6 against plain and against B3/B4 -----
    step0 = trainer.make_train_step(opt, cfg0, bg,
                                    lrs=optim.group_lrs(opt, 1.0), device=dev)
    s1_args = (state, optim.adam_init(state["params"]), cam, 1.0, 1.6e-4)
    with Capture() as cap0:
        step0(*s1_args)
    torch.cuda.synchronize()
    c0 = cap0.calls
    if any(k in c0 for k in strip_kernels):
        raise AssertionError("the strip-0 step called the image-layout blend")
    e5, e6 = compare_tiles(c0, "strip 0, bench step")
    compare_binning(c0)
    for (name, tile), ec in edge_calls.items():
        compare_tiles(ec, f"edge inputs {name}, tile {tile}")

    # ---- 19. stage 2 at strip 0: five S = 24 steps and an eval render ----
    s2_state, bake, env0, step2_8, s2_args8 = s2
    step2_0 = trainer.make_svgss_train_step(
        opt, cfg0, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    st2 = {**s2_state, "stats": state["stats"]}
    ost2, env2 = optim.adam_init(st2["params"]), env0
    torch.cuda.synchronize()
    kernels.reset_launches()
    s2_hist = []
    for i in range(steps):
        st2, ost2, env2, tb2 = step2_0(st2, ost2, env2, bake, cam, 100.0 + i,
                                       1e-5, opt.radiance_lr)
        s2_hist.append((float(tb2["loss"]), bool(tb2["overflow"])))
    torch.cuda.synchronize()
    l19 = kernels.launches()
    log(f"[strip0 s2 train] {steps} steps: losses "
        f"{[round(x, 6) for x, _ in s2_hist]}; launches {l19}")
    if any(not math.isfinite(x) or o for x, o in s2_hist):
        raise AssertionError(f"strip-0 stage-2 train: bad step {s2_hist}")
    for k, v in list(st2["params"].items()) + [("env",
                                                env2["params"]["env"])]:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"strip-0 stage-2 train: non-finite {k}")
    check_launches(l19, "strip-0 stage-2 train", at_least=(
        ("blend_forward_tiles", steps), ("blend_backward_tiles", steps),
        ("env_lookup_forward", steps), ("env_lookup_backward", steps)),
        none=strip_kernels)
    s2_args0 = ({**s2_state, "stats": state["stats"]},
                optim.adam_init(s2_state["params"]), env0, bake, cam, 100.0,
                1e-5, opt.radiance_lr)
    with Capture() as cap19:
        step2_0(*s2_args0)

    def render_s2(c):
        with torch.no_grad():
            return render_view_svgss(cam, s2_state["params"], bake,
                                     env0["params"], bg, is_training=False,
                                     alive=s2_state["alive"], cfg=c)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap19e:
        res2 = render_s2(cfg0)
    torch.cuda.synchronize()
    l19e = kernels.launches()
    for k in ("render", "pbr", "pbr_env", "base_color", "direct", "indirect"):
        if tuple(res2[k].shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(res2[k]).all()):
            raise AssertionError(f"strip-0 stage-2 render: bad {k} image")
    check_launches(l19e, "strip-0 stage-2 eval render",
                   at_least=(("blend_forward_tiles", 1),
                             ("env_lookup_forward", 1)), none=strip_kernels)
    widths = [(c.calls["blend_forward_tiles"][1]["ca"],
               c.calls["blend_forward_tiles"][1]["cv"]) for c in (cap19,
                                                                  cap19e)]
    if widths != [(13, 13), (16, 16)]:
        raise AssertionError(f"strip-0 stage-2 blend widths {widths}")
    e5s2, e6s2 = compare_tiles(cap19.calls,
                               "strip 0, stage-2 step CA=13 CV=13")
    e5s2e, _ = compare_tiles(cap19e.calls, "strip 0, stage-2 eval CA=16 CV=16")

    # ---- 20. the sort binner: render_view_stage1(binner="sort") ----------
    cfg_sort = RasterConfig(binner="sort", max_instances=cfg.max_instances)

    def render1(c):
        with torch.no_grad():
            return render_view_stage1(cam, state["params"], bg,
                                      alive=state["alive"], cfg=c)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap20:
        res_sort = render1(cfg_sort)
    torch.cuda.synchronize()
    l20 = kernels.launches()
    img_s = res_sort["render"]
    if tuple(img_s.shape) != (3, cam.height, cam.width) or \
            not bool(torch.isfinite(img_s).all()):
        raise AssertionError("sort-binner render: bad image")
    if bool(res_sort["overflow"]):
        raise AssertionError("sort-binner render: overflow")
    check_launches(l20, "sort-binner render",
                   at_least=(("blend_forward_tiles", 1),),
                   none=strip_kernels + ("binning_counts",
                                         "binning_instances"))
    img_c = render1(cfg)["render"]
    d_img = (img_s - img_c).abs()
    if not bool((d_img <= TOL_IMG * (1 + img_c.abs())).all()):
        raise AssertionError(f"sort-binner render differs from the counting "
                             f"render by {float(d_img.max())}")
    (prep,), bkw = cap20.calls["bin_instances"]
    prep_cpu = type(prep)(*(x.detach().cpu() for x in prep))
    chunk, cap = cfg_sort.chunk, cfg_sort.max_instances
    b_d = BN.bin_instances(prep, **bkw)
    b_c = BN.bin_instances(prep_cpu, **bkw)
    p_d = BN.pad_to_chunks(b_d, chunk=chunk, max_instances=cap)
    p_c = BN.pad_to_chunks(b_c, chunk=chunk, max_instances=cap)
    cnt = BN.bin_instances_counting(prep, **bkw)
    for label, x, y, fields in (
            ("bin_instances", b_d, b_c, BN.BinnedInstances._fields),
            ("pad_to_chunks", p_d, p_c, BN.PaddedInstances._fields[:-1]),
            ("counting binner", p_d, cnt, ("gaussian_id", "tile_start",
                                           "tile_count", "num_instances"))):
        for f in fields:
            if not torch.equal(getattr(x, f).cpu(), getattr(y, f).cpu()):
                raise AssertionError(f"sort binner on the card: {f} of "
                                     f"{label} differs")
    e5s, _ = compare_tiles(cap20.calls, "sort binner, bench render")
    log(f"[sort] render_view_stage1(binner='sort') at cap {cap}: "
        f"{int(b_d.num_instances)} instances ({int(p_d.num_instances)} "
        f"padded); integers equal to the CPU's (bin_instances, "
        f"pad_to_chunks) and to the counting binner's layout; image within "
        f"{float(d_img.max()):.3g} of the counting render; launches {l20}")

    # ---- 21. small-scene parity: card vs CPU, and vs render_dense --------
    sc_dev, cam_dev = small_scene(dev)
    sc_cpu, cam_cpu = small_scene("cpu")
    small_bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    for label, c in (("strip 0", RasterConfig(max_instances=1 << 18,
                                              strip=0)),
                     ("sort", RasterConfig(max_instances=1 << 18,
                                           binner="sort"))):
        torch.cuda.synchronize()
        kernels.reset_launches()
        bufs_d, grads_d = run_small(sc_dev, cam_dev, dev, c)
        torch.cuda.synchronize()
        check_launches(kernels.launches(), f"small scene, {label}",
                       at_least=(("blend_forward_tiles", 1),
                                 ("blend_backward_tiles", 1)),
                       none=strip_kernels)
        bufs_c, grads_c = run_small(sc_cpu, cam_cpu, "cpu", c)
        for f in ("color", "depth", "normal", "feature", "vfeature",
                  "opacity"):
            e = max_err_rel(getattr(bufs_d, f).detach().cpu(),
                            getattr(bufs_c, f).detach())
            if e > 1e-4:
                raise AssertionError(f"parity ({label}): {f} differs by {e}")
        for k in grads_c:
            e = max_err_rel(grads_d[k].cpu(), grads_c[k])
            if e > 1e-3:
                raise AssertionError(f"parity ({label}): d{k} differs by {e}")
        with torch.no_grad():
            p = preprocess(
                sc_dev["means"], sc_dev["scales"], sc_dev["quats"],
                cam_dev.world_view, cam_dev.full_proj, cam_dev.camera_center,
                width=cam_dev.width, height=cam_dev.height,
                tanfovx=cam_dev.tanfovx, tanfovy=cam_dev.tanfovy,
                focal_x=cam_dev.focal_x, focal_y=cam_dev.focal_y,
                colors=sc_dev["colors"], cfg=c)
            dense = render_dense(p, sc_dev["opacity"], sc_dev["features"],
                                 sc_dev["vfeatures"], small_bg,
                                 width=cam_dev.width, height=cam_dev.height,
                                 cfg=c)
        worst = max(float((getattr(bufs_d, f).detach()
                           - getattr(dense, f)).abs().max())
                    for f in ("color", "normal", "feature", "vfeature",
                              "opacity", "final_t"))
        if worst > TOL_DENSE_IMG:
            raise AssertionError(f"small scene ({label}) differs from "
                                 f"render_dense by {worst}")
        op = dense.opacity[0] > 0.05
        e_depth = max_err_rel(bufs_d.depth.detach()[0][op], dense.depth[0][op])
        e_w = max_err_rel(bufs_d.weights.detach(), dense.weights)
        nc = int((bufs_d.n_contrib != dense.n_contrib).sum())
        if e_depth > TOL_DENSE_REL or e_w > TOL_DENSE_REL or \
                nc > TOL_DENSE_NC * dense.n_contrib.numel():
            raise AssertionError(f"small scene ({label}) against render_dense:"
                                 f" depth {e_depth}, weights {e_w}, n_contrib "
                                 f"{nc} pixels")
        log(f"[small] {label}: card == CPU (image 1e-4, gradients 1e-3 of "
            f"max); against render_dense on the card: images within "
            f"{worst:.3g}, depth {e_depth:.3g} and weights {e_w:.3g} of max, "
            f"n_contrib differs at {nc} pixels")

    # ---- 22. B9 against its plain versions, bitwise ----------------------
    m9 = -(-cfg.max_instances // 1024) * 1024
    kr = c0["blend_forward_tiles"][0][0].shape[1]
    x9 = torch.randn(m9, kr, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    kernels.reset_launches()
    kp = KC.pad_cols(x9, B9_KOUT)
    ks = KC.slice_cols(kp, kr)
    same = BP.pad_cols(x9, kr)
    pp = BP.pad_cols_plain(x9, B9_KOUT)
    torch.cuda.synchronize()
    e9 = {"pad_cols": float((kp - pp).abs().max()),
          "slice_cols": float((ks - BP.slice_cols_plain(pp, kr)).abs().max())}
    if not (torch.equal(kp, pp) and torch.equal(ks, BP.slice_cols_plain(pp, kr))
            and torch.equal(ks, x9) and same is x9):
        raise AssertionError("B9 differs from its plain versions")
    check_launches(kernels.launches(), "B9",
                   at_least=(("pad_cols", 1), ("slice_cols", 1)))
    # the slice at its edges: kout 1, kin - 1, an odd kout (4-byte loads),
    # M of one block, and an input 4 bytes off 8-byte alignment
    kx = kp[:1024].contiguous()
    off = torch.empty(1024 * 126 + 1, device=dev)[1:].view(1024, 126)
    off.copy_(kp[:1024, :126])
    for label, xx, ko in (("kout 1", kp, 1), ("kin - 1", kp, B9_KOUT - 1),
                          ("odd kout 13", kp, 13), ("M = 1024", kx, kr),
                          ("4 bytes off alignment", off, 64)):
        got = KC.slice_cols(xx, ko)
        if not torch.equal(got, BP.slice_cols_plain(xx, ko)):
            raise AssertionError(f"B9 slice differs from its plain version "
                                 f"({label}: {tuple(xx.shape)} -> {ko})")
    for p in parents:
        if not (torch.equal(p["pad_cols"](x9, B9_KOUT), kp) and
                torch.equal(p["slice_cols"](kp, kr), ks)):
            raise AssertionError(f"B9 differs from {p['label']}'s")
    log(f"[cols] B9 at M={m9}: pad {kr} -> {B9_KOUT} and slice back equal "
        "to F.pad and the slice copy, bit for bit; the slice also at kout "
        "1, 127 and 13, M = 1024 and on an input off 8-byte alignment")

    # ---- 23. timing --------------------------------------------------------
    step8_fn, step8_args = step8
    t = {}
    for label, fn in (("strip 8", lambda: step8_fn(*step8_args)),
                      ("strip 0", lambda: step0(*s1_args)),
                      ("strip 0 again", lambda: step0(*s1_args)),
                      ("strip 8 again", lambda: step8_fn(*step8_args))):
        t[label] = host_ms(fn, reps=10)
    r = {label: host_ms(lambda: render1(c), reps=10)
         for label, c in (("counting, strip 8", cfg),
                          ("counting, strip 0", cfg0), ("sort", cfg_sort))}
    t2 = {label: host_ms(fn, reps=10) for label, fn in (
        ("stage 2, strip 8", lambda: step2_8(*s2_args8)),
        ("stage 2, strip 0", lambda: step2_0(*s2_args0)),
        ("eval render, strip 8", lambda: render_s2(cfg)),
        ("eval render, strip 0", lambda: render_s2(cfg0)))}
    log(f"[tiles timing] stage-1 train step (median of 10, in turns): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items())
        + "; forward render: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in r.items())
        + "; " + ", ".join(f"{k} {v:.3f} ms" for k, v in t2.items())
        + f"; cap {cfg.max_instances}; card: {card}")
    if profile_dir:
        profile_step(lambda: step0(*s1_args), profile_dir,
                     "chip_smoke_profile_strip0.txt")

    bnd = bounds(c0, tiles=True)
    bnd2 = bounds(cap19.calls, tiles=True)
    bnd2e = bounds(cap19e.calls, tiles=True)
    bnd_s = bounds(cap20.calls, tiles=True)
    src_f = "svgir_tpu_torch/csrc/blend_forward.cu"
    src_b = "svgir_tpu_torch/csrc/blend_backward.cu"
    rep_f, rep_b = ("svgir_tpu/ops/blend_pallas.py:197",
                    "svgir_tpu/ops/blend_pallas.py:429")
    fw, bw = "blend_forward_tiles", "blend_backward_tiles"
    timed = {}
    for name, calls, bd, lc, ef, eb in (
            ("", c0, bnd, l17, e5, e6),
            ("_stage2", cap19.calls, bnd2, l19, e5s2, e6s2),
            ("_stage2_eval", cap19e.calls, bnd2e, l19e, e5s2e, None),
            ("_sort", cap20.calls, bnd_s, l20, e5s, None)):
        a5, kw5 = calls[fw]
        timed[fw + name] = (
            lambda a5=a5, kw5=kw5: KBL.blend_forward_tiles(*a5, **kw5),
            lambda a5=a5, kw5=kw5: BP.blend_forward_plain(*a5, **kw5),
            rep_f, src_f, lc[fw], ef, bd[fw], None)
        if eb is not None:
            a6, kw6 = calls[bw]
            timed[bw + name] = (
                lambda a6=a6, kw6=kw6: KBL.blend_backward_tiles(*a6, **kw6),
                lambda a6=a6, kw6=kw6: BP.blend_backward_plain(*a6, **kw6),
                rep_b, src_b, lc[bw], eb, bd[bw], None)
    for name, kfn, pfn, lfn, rep, nbytes in (
            ("pad_cols", lambda: KC.pad_cols(x9, B9_KOUT),
             lambda: BP.pad_cols_plain(x9, B9_KOUT),
             lambda: F.pad(x9, (0, B9_KOUT - kr)),
             "svgir_tpu/ops/blend_pallas.py:748", 4 * m9 * (kr + B9_KOUT)),
            ("slice_cols", lambda: KC.slice_cols(kp, kr),
             lambda: BP.slice_cols_plain(kp, kr),
             lambda: kp[:, :kr].contiguous(),
             "svgir_tpu/ops/blend_pallas.py:774", 8 * m9 * kr)):
        # launches on the main paths run above (phases 17, 19 and 20): B9
        # has no caller in the port, so these read 0
        lc = sum(c[name] for c in (l17, l19, l19e, l20))
        timed[name] = (kfn, pfn, rep, "svgir_tpu_torch/csrc/cols.cu", lc,
                       e9[name], (nbytes / HBM_BYTES_S * 1e3, "bytes"), lfn)
    report = []
    for name, (kfn, pfn, rep, src, lc, err, bd, lfn) in timed.items():
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lc, "max_abs_err": err, **t,
            "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[tiles timing] {name}: " + fmt_times(t, "F.pad / slice copy")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; {lc} launches on its "
            f"path; card: {card}")
        if name in ("pad_cols", "slice_cols"):
            for p in parents:
                a = (x9, B9_KOUT) if name == "pad_cols" else (kp, kr)
                o = in_turns(lambda p=p, a=a: p[name](*a), kfn)
                report[-1].setdefault("parent", {})[p["label"]] = o
                log_turns(o, f"{p['label']} {name}", card)
    for calls, label, suffix in ((c0, "strip 0, stage 1", ""),
                                 (cap19.calls, "strip 0, stage-2 step",
                                  "_stage2"),
                                 (cap19e.calls, "strip 0, stage-2 eval",
                                  "_stage2_eval")):
        kw = calls[fw][1]
        geo = dict(ca=kw["ca"], cv=kw["cv"], tile=kw["tile"],
                   chunk=kw["chunk"], tiles=True)
        cp = {p["label"]: compare_parent(p, calls, label, card, tiles=True)
              for p in parents}
        for entry in report:
            for direction, name in (("forward", fw + suffix),
                                    ("backward", bw + suffix)):
                if entry["name"] == name:
                    entry["build"] = blend_build(ptx, direction, **geo)
                    parent_times = {k: v[direction] for k, v in cp.items()
                                    if direction in v}
                    if parent_times:
                        entry["parent"] = parent_times
    log(f"[tiles] phases 17-23: {time.time() - t_tiles:.1f} s")
    return report


def blend_extras(report, calls, label, ptx, parents, card, names=None):
    """Adds to the blend entries of ``report`` (B3 and B4 on ``calls``) the
    kernel each launch takes with its registers and spills and, with
    --parent, each other tree's kernels timed in turns beside them
    ({label: times} under "parent")."""
    a, kw = calls["blend_forward"]
    geo = dict(ca=kw["ca"], cv=kw["cv"], tile=kw["tile"], chunk=kw["chunk"])
    names = names or {"forward": "blend_forward",
                      "backward": "blend_backward"}
    if "blend_backward" not in calls:
        names = {k: v for k, v in names.items() if k == "forward"}
    cp = {p["label"]: compare_parent(p, calls, label, card) for p in parents}
    for entry in report:
        for direction, name in names.items():
            if entry["name"] == name:
                entry["build"] = blend_build(ptx, direction, **geo)
                if cp:
                    entry["parent"] = {k: v[direction] for k, v in cp.items()}
                log(f"[build] {name}: {entry['build']}")


def log_warp_visits(work, kw, label):
    """The shuffle model of the blend backward on these inputs: the (warp,
    real row) visits where some pixel of the warp passes the footprint
    test, for each warp patch, and the warp shuffles they cost: the old
    layout (32 x 1 patches, 5 shuffles per row) against the new one (16
    per group of 16 rows)."""
    ca, cv = kw["ca"], kw["cv"]
    rows_old = 12 + ca + 4 * cv
    rows_new = (12 if cv else 6) + ca + 4 * cv
    v = work["warp_visits"]
    old = v["32x1"] * 5 * rows_old
    log(f"[work] {label}: warp visits with a pixel past the footprint test "
        f"of {work['warp_visit_total']['32x1']} (32 x 1 patches): "
        + ", ".join(f"{k} {n}" for k, n in v.items())
        + f"; backward shuffles, old layout {old} ("
        f"{v['32x1']} x 5 x {rows_old}), new: "
        + ", ".join(f"{k} {n * -(-rows_new // 16) * 16}"
                    for k, n in v.items() if k != "32x1"))


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
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.ops import binning as BN
    from svgir_tpu_torch.ops import binning_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.ops.preprocess import preprocess
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import optim, trainer
    inputs = kernel_inputs()

    dev = "cuda"
    t_start = time.time()
    # ---- 1. build ------------------------------------------------------
    t0 = time.time()
    build.build()
    for stem in ("binning", "blend_forward", "blend_backward", "cols",
                 "env_lookup", "launch_floor", "march"):
        build.library(stem)
    card = nvidia_smi()
    log(f"[build] {time.time() - t0:.1f} s; card: {card}")
    build_log = (build.BUILD_DIR / "build.log").read_text() \
        if (build.BUILD_DIR / "build.log").exists() else ""
    for line in build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Function properties",
                                   "==")):
            log("[ptxas] " + line.strip())
    ptx = ptxas_blend(build_log)
    for (direction, args), v in sorted(ptx.items()):
        log(f"[ptxas] blend {direction} <{', '.join(map(str, args))}>: {v}")
    parents = [parent_kernels(sys.argv[i + 1])
               for i, a in enumerate(sys.argv[1:-1], 1) if a == "--parent"]
    for p in parents:
        for (direction, args), v in sorted(ptxas_blend(p["ptxas"]).items()):
            log(f"[ptxas] {p['label']}'s blend {direction} "
                f"<{', '.join(map(str, args))}>: {v}")

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
    # B1 on the bench scene at tile 16 (2,500 tiles) and on the synthetic
    # rects of the CPU tests (tests/torch_kernel_inputs.py)
    p1 = state["params"]
    cfg16 = RasterConfig(tile=16)
    with torch.no_grad(), Capture() as cap16:
        prep16 = preprocess(
            p1["xyz"], G.get_scaling(p1), G.get_rotation(p1), cam.world_view,
            cam.full_proj, cam.camera_center, width=cam.width,
            height=cam.height, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            focal_x=cam.focal_x, focal_y=cam.focal_y,
            colors=torch.zeros_like(p1["xyz"]), cfg=cfg16)
        BN.bin_instances_counting(prep16, width=cam.width, height=cam.height,
                                  cfg=cfg16)
    done = [compare_counts(*cap16.calls["compute_counts"],
                           "bench scene, tile 16")]
    done_b2 = [compare_instances(*cap16.calls["compute_instances"],
                                 "bench scene, tile 16")]
    # B2 at its edge cases (a chunk whose rects all cover one tile, one of
    # empty and inverted rects, a last chunk ending in padding, m past and
    # below total_raw, tile 16, the wide grids, walked in bands) and on
    # B1's synthetic rects clipped to their grids
    for name in inputs.INSTANCE_CASES:
        done_b2.append(compare_instances(
            *instance_case(inputs.instance_inputs(name), dev), name))
    for name in inputs.RECT_CASES:
        rects, (gx, gy) = inputs.synthetic_rects(name)
        done_b2.append(compare_instances(*instance_case(
            inputs.instances_from_rects(rects, gx, gy), dev),
            f"synthetic {name}"))
    for name in inputs.RECT_CASES:
        rects, (gx, gy) = inputs.synthetic_rects(name)
        done.append(compare_counts(
            [torch.from_numpy(r).to(dev) for r in rects],
            dict(grid_x=gx, grid_y=gy), f"synthetic {name}"))
    for gx, gy in ((256, 256), (60_000, 3)):
        # past a block's shared memory: counted in bands of tile rows (256 x
        # 256: tile 16 over 4,096 x 4,096) or of a row's columns (60,000 x 3)
        done.append(compare_counts(
            [torch.from_numpy(r).to(dev)
             for r in inputs.wide_grid_rects(gx, gy)],
            dict(grid_x=gx, grid_y=gy), f"wide grid {gx} x {gy}"))
    log("[kernels] B1 equal to its plain version on " + "; ".join(done))
    log("[kernels] B2 equal to its plain version on " + "; ".join(done_b2))
    err3, err4 = compare_blend(calls, "bench")
    # the blend's edge inputs at every exact width and a generic one, at
    # every tile the wrappers take (32 is the main path's; at 24 and 8 the
    # stage-1 backward's 4-pixel lane patches do not fit, so it takes the
    # generic kernel)
    edge_calls, err3e, err4e = {}, 0.0, 0.0
    for tile in (32, 24, 16, 8):
        for name in inputs.BLEND_EDGE_CASES:
            ec = blend_edge_calls(inputs, name, tile, dev)
            edge_calls[(name, tile)] = ec
            e3x, e4x = compare_blend(ec, f"edge inputs {name}, tile {tile}")
            err3e, err4e = max(err3e, e3x), max(err4e, e4x)

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
    err3, err4 = max(err3, e3s, err3e), max(err4, e4s, err4e)

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
    lib_b1 = library_counts_carry(calls)
    lc, lcar = lib_b1()
    kc, kcar = KB.counts(*a1, **kk1)
    if not (torch.equal(lc, kc) and torch.equal(lcar, kcar)):
        raise AssertionError("the B1 yardstick computes another function")
    lib_b1_counts = library_counts(calls)
    timed = {
        "binning_counts": (lambda: KB.counts(*a1, **kk1),
                           lambda: BP.counts_plain(*a1, **kk1), lib_b1),
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
        t = timings(kfn, pfn, lfn)
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": errs[name], **t,
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
        extra = ""
        if name == "binning_counts":
            entry["library_counts_only_ms"] = cuda_ms(lib_b1_counts, reps=20)
            entry["library_counts_only_device_ms"] = device_ms(
                lib_b1_counts)[0]
            extra = (f"; counts-only bincount + 2-D cumsum "
                     f"{entry['library_counts_only_ms']:.4f} ms per call, "
                     f"{entry['library_counts_only_device_ms']:.4f} ms on "
                     "the device")
        report.append(entry)
        log(f"[timing] {name}: " + fmt_times(t, "bincount + cumsums")
            + f", bound {bnd[name][0]:.4f} ms by {bnd[name][1]}{extra}; "
            f"card: {card}")
    blend_extras(report, calls, "stage 1", ptx, parents, card)
    log_warp_visits(wk, kw3, "stage 1")
    # B2 against each --parent tree's, in turns, on the bench step's inputs
    b2_entry = next(e for e in report if e["name"] == "binning_instances")
    for p in parents:
        compare_instances(a2, kw2, f"captured, {p['label']}'s kernel",
                          kernel=p["instances"])
        o = in_turns(lambda p=p: p["instances"](*a2, **kw2),
                     lambda: KB.instances(*a2, **kw2))
        b2_entry.setdefault("parent", {})[p["label"]] = o
        log_turns(o, f"{p['label']} binning_instances", card)
    # the launch floor: an empty kernel of one block of 32 threads, and of
    # B2's grid on these inputs (a block per chunk, one per 2,048 slots)
    b2_grid = a2[0].numel() // kw2["gauss_chunk"] + -(-kw2["m"] // 2048)
    floor = {}
    for label, fn in (("1 x 32", launch_floor()),
                      (f"{b2_grid} x 512", launch_floor(b2_grid, 512))):
        floor[label] = (device_ms(fn)[0], cuda_ms(fn, reps=20))
        log(f"[timing] launch floor, empty kernel of {label} threads: "
            f"{floor[label][0]:.4f} ms on the device, {floor[label][1]:.4f} "
            f"ms per call; card: {card}")
    floor_ms = floor["1 x 32"][0]
    # B1 on a grid past a block's shared memory (counted in bands; no main
    # path runs such a grid, so 0 launches)
    rw = [torch.from_numpy(r).to(dev) for r in inputs.wide_grid_rects(256, 256)]
    kkw = dict(grid_x=256, grid_y=256, gauss_chunk=256)
    lib_w = library_counts_carry({"compute_counts": (rw, kkw)})
    lc, lcar = lib_w()
    kc, kcar = KB.counts(*rw, **kkw)
    if not (torch.equal(lc, kc) and torch.equal(lcar, kcar)):
        raise AssertionError("the B1 yardstick computes another function on "
                             "the wide grid")
    t = timings(lambda: KB.counts(*rw, **kkw),
                lambda: BP.counts_plain(*rw, **kkw), lib_w)
    nsw, tw = rw[0].numel(), 256 * 256
    bw = (16 * nsw + 4 * tw + 4 * (nsw // 256) * tw) / HBM_BYTES_S * 1e3
    report.append({
        "name": "binning_counts_wide_grid", "route": "cuda",
        "source": sources["binning_counts"],
        "replaces": replaces["binning_counts"], "launches": 0,
        "max_abs_err": 0.0, **t, "bound_ms": bw, "bound_by": "bytes"})
    log(f"[timing] binning_counts on a 256 x 256 grid ({nsw} rects, in "
        f"bands): " + fmt_times(t, "bincount + cumsums") + f", bound "
        f"{bw:.4f} ms by bytes; card: {card}")

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
    for k in STAGE2_KERNELS:
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
    evals = cap_s2_render.every["env_lookup_forward"]
    e7fe = [compare_env_forward(a, f"stage-2 eval call {i}")
            for i, (a, _) in enumerate(evals)]
    e7f_edge, e7b_edge = 0.0, 0.0
    for h, w in ((16, 32), (32, 64)):
        for m in (37, 1_027, 20_003):
            env, u, v, g = inputs.env_lookup_inputs(h, w, 3, m, seed=m)
            env, u, v, g = (torch.from_numpy(x).to(dev) for x in (env, u, v, g))
            lab = f"edge cases {h}x{w}, M={m}"
            e7f_edge = max(e7f_edge, compare_env_forward((env, u, v), lab))
            e7b_edge = max(e7b_edge, compare_env_backward(u, v, g, h, w, lab))
            # u, v and g starting 4 bytes into their buffers: not 16-byte
            # aligned
            lab = f"edge cases {h}x{w}, M={m - 1}, unaligned"
            e7f_edge = max(e7f_edge, compare_env_forward(
                (env, u[1:], v[1:]), lab))
            e7b_edge = max(e7b_edge, compare_env_backward(
                u[1:], v[1:], g.reshape(-1)[1:3 * m - 2].reshape(m - 1, 3),
                h, w, lab))
    log(f"[kernels] B7 forward on the eval render's {len(evals)} lookups "
        f"({', '.join(str(a[1].numel()) for a, _ in evals)} queries): "
        f"max|err| {max(e7fe):.3g}; on the edge cases (16x32 and 32x64, "
        f"M 37, 1,027, 20,003 and one less, unaligned): forward "
        f"{e7f_edge:.3g}, backward {e7b_edge:.3g}")
    # B7's backward on an env that fits one copy a block but too few for
    # one a warp (64x128: the route of shared atomics)
    env, u, v, g = (torch.from_numpy(x).to(dev)
                    for x in inputs.env_lookup_inputs(64, 128, 3, 20_003))
    e7b_mid = compare_env_backward(u, v, g, 64, 128, "env 64x128, M=20003")
    log(f"[kernels] B7 backward on a 64x128 env (one copy a block, M "
        f"20,003): max|err| {e7b_mid:.3g}")
    # envs past a block's shared memory: read in place, gradient summed in
    # slices
    e7_wide = [0.0, 0.0]
    for h, w in ((128, 256), (256, 512)):
        env, u, v, g = (torch.from_numpy(x).to(dev)
                        for x in inputs.env_lookup_inputs(h, w, 3, 20_003))
        for uu, vv, gg, tag in ((u, v, g, ""), (u[1:], v[1:],
                                                g[1:].contiguous(),
                                                ", unaligned")):
            lab = f"env {h}x{w}, M={uu.numel()}{tag}"
            e7_wide[0] = max(e7_wide[0], compare_env_forward((env, uu, vv),
                                                             lab))
            e7_wide[1] = max(e7_wide[1], compare_env_backward(uu, vv, gg, h,
                                                              w, lab))
    log(f"[kernels] B7 on envs past shared memory (128x256, 256x512; M "
        f"20,003 and one less, unaligned): forward max|err| "
        f"{e7_wide[0]:.3g}, backward {e7_wide[1]:.3g}")
    compare_binning(c2)
    compare_binning(cap_s2_render.calls)
    e3s2, e4s2 = compare_blend(c2, "stage-2 step CA=13 CV=13")
    e3s2e, _ = compare_blend(cap_s2_render.calls, "stage-2 eval CA=16 CV=16")

    # ---- 9b. a stage-2 step with a 128 x 256 env (train.py
    # --env_resolution 128; H = 128 is direct_light_map_init's default
    # argument, the configuration's default is 16): B7 past shared memory
    s2_128, bake128, env128 = stage2_inputs(state, dev, env_h=128)
    st128 = {**s2_128, "stats": state["stats"]}
    s2_args128 = (st128, optim.adam_init(st128["params"]), env128, bake128,
                  cam, 100.0, 1e-5, opt.radiance_lr)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap128:
        _, _, env128b, tb128 = step2(*s2_args128)
    torch.cuda.synchronize()
    l128 = kernels.launches()
    if not math.isfinite(float(tb128["loss"])) or bool(tb128["overflow"]):
        raise AssertionError("stage-2 step, env 128: bad step")
    if not bool(torch.isfinite(env128b["params"]["env"]).all()) or \
            not bool((env128b["opt"]["m"]["env"] != 0).any()):
        raise AssertionError("stage-2 step, env 128: the env got no finite "
                             "gradient")
    check_launches(l128, "stage-2 step, env 128", at_least=(
        ("env_lookup_forward", 1), ("env_lookup_backward", 1),
        ("blend_forward", 1), ("blend_backward", 1)))
    e7f128, e7b128 = compare_env(cap128.calls, "stage-2 step, env 128x256")
    log(f"[s2 env 128] loss {float(tb128['loss']):.6f}, launches {l128}")

    # ---- 10. stage-2 parity: card vs CPU (16 x 32 and 128 x 256 envs) ---
    for env_h in (16, 128):
        ev_d, r_d, g_d = run_small_stage2(dev, env_h)
        ev_c, r_c, g_c = run_small_stage2("cpu", env_h)
        for k in ("render", "pbr", "base_color", "roughness", "direct",
                  "indirect", "pbr_env", "render_env", "opacity"):
            f = 2 if k in ("direct", "indirect") else 1
            e = float((ev_d[k].cpu() - ev_c[k]).abs().max())
            if e > f * TOL_S2_IMG:
                raise AssertionError(f"s2 parity: {k} differs by {e}")
        e = float(((ev_d["depth"].cpu() - ev_c["depth"]).abs()
                   / ev_c["depth"].abs().clamp(min=1e-6)).max())
        if e > TOL_S2_DEPTH:
            raise AssertionError(f"s2 parity: depth differs by {e} "
                                 "(relative)")
        el = abs(r_d["loss"].item() - r_c["loss"].item())
        if el > 1e-5 * max(1.0, abs(r_c["loss"].item())):
            raise AssertionError(f"s2 parity: loss differs by {el}")
        if sorted(g_d) != sorted(g_c):
            raise AssertionError("s2 parity: different groups got gradients")
        worst = max((max_err_rel(g_d[k].cpu(), g_c[k]), k) for k in g_c)
        if worst[0] > TOL_S2_GRAD:
            raise AssertionError(f"s2 parity: d{worst[1]} differs by "
                                 f"{worst[0]} of its largest magnitude")
        log(f"[s2 parity] small stage-2 scene, env {env_h}x{2 * env_h}: "
            f"card == CPU (images {TOL_S2_IMG}, depth {TOL_S2_DEPTH} "
            f"relative, loss within {el:.3g}, gradients within "
            f"{worst[0]:.3g} of max, worst d{worst[1]})")

    # ---- 11. stage-2 timing ---------------------------------------------
    step2_ms = host_ms(lambda: step2(*s2_args), reps=10)
    render2_ms = host_ms(render_s2, reps=10)
    log(f"[s2 timing] cap {cfg.max_instances}: stage-2 train step "
        f"{step2_ms:.3f} ms; eval render {render2_ms:.3f} ms; card: {card}")
    bnd2 = bounds(c2)
    bnd2e = bounds({**c2, "blend_forward": cap_s2_render.calls[
        "blend_forward"]})
    fa, _ = c2["env_lookup_forward"]
    ba, bkw = c2["env_lookup_backward"]
    bnd_env = env_bounds(fa)
    b3, kw3s = c2["blend_forward"]
    b4, kw4s = c2["blend_backward"]
    b3e, kw3e = cap_s2_render.calls["blend_forward"]
    timed2 = {
        "env_lookup_forward": (
            lambda: KE.env_lookup_forward(*fa),
            lambda: EP.env_lookup_forward_plain(*fa),
            "svgir_tpu/ops/env_lookup_pallas.py:63",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7f,
            bnd_env["env_lookup_forward"], library_env_forward(fa)),
        "env_lookup_backward": (
            lambda: KE.env_lookup_backward(*ba, **bkw),
            lambda: EP.env_lookup_backward_plain(*ba, **bkw),
            "svgir_tpu/ops/env_lookup_pallas.py:76",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7b,
            bnd_env["env_lookup_backward"], library_env_backward(c2)),
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
    # B7 on the env-128 step's lookups (the env read in place, the
    # gradient added with atomics)
    fa128, _ = cap128.calls["env_lookup_forward"]
    ba128, bkw128 = cap128.calls["env_lookup_backward"]
    for name, kfn, pfn, rep_, err, direction, lfn in (
            ("env_lookup_forward_stage2_env128",
             lambda: KE.env_lookup_forward(*fa128),
             lambda: EP.env_lookup_forward_plain(*fa128),
             "svgir_tpu/ops/env_lookup_pallas.py:63", e7f128,
             "env_lookup_forward", library_env_forward(fa128)),
            ("env_lookup_backward_stage2_env128",
             lambda: KE.env_lookup_backward(*ba128, **bkw128),
             lambda: EP.env_lookup_backward_plain(*ba128, **bkw128),
             "svgir_tpu/ops/env_lookup_pallas.py:76", e7b128,
             "env_lookup_backward", library_env_backward(cap128.calls))):
        timed2[name] = (kfn, pfn, rep_, "svgir_tpu_torch/csrc/env_lookup.cu",
                        l128, err, env_bounds(fa128)[direction], lfn)
    # B7's forward on each of the eval render's lookups (1.2M bake
    # directions and 640,000 camera rays)
    for i, (a, _) in enumerate(evals):
        timed2["env_lookup_forward_stage2_eval" + (f"_{i + 1}" if i else "")] \
            = (lambda a=a: KE.env_lookup_forward(*a),
               lambda a=a: EP.env_lookup_forward_plain(*a),
               "svgir_tpu/ops/env_lookup_pallas.py:63",
               "svgir_tpu_torch/csrc/env_lookup.cu", s2_render_launches,
               e7fe[i], env_bounds(a)["env_lookup_forward"],
               library_env_forward(a))
    for name, (kfn, pfn, rep, src, lc, err, bd, lfn) in timed2.items():
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        key = name.split("_stage2")[0]
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lc[key], "max_abs_err": err, **t,
            "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[s2 timing] {name}: " + fmt_times(t, "grid_sample")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; card: {card}")
    # B7's backward against each --parent tree's, in turns
    for name, (b_, bkw_), label in (
            ("env_lookup_backward", (ba, bkw), "S = 24 step"),
            ("env_lookup_backward_stage2_env128", (ba128, bkw128),
             "env 128x256 step")):
        times = parent_env_backward(parents, b_, bkw_, label, card)
        if times:
            next(e for e in report if e["name"] == name)["parent"] = times
    blend_extras(report, c2, "stage-2 step", ptx, parents, card,
                 {"forward": "blend_forward_stage2",
                  "backward": "blend_backward_stage2"})
    blend_extras(report, cap_s2_render.calls, "stage-2 eval", ptx, parents,
                 card, {"forward": "blend_forward_stage2_eval"})
    wk2 = bnd2["blend_work"]
    log_warp_visits(wk2, kw3s, "stage 2")
    log(f"[s2 timing] blend work on the stage-2 step's inputs: {wk2['rows']} "
        f"real rows, {wk2['pairs']} pairs, {wk2['ok']} pass the footprint "
        f"test, {wk2['gated']} blend; {fa[1].numel()} env queries per step")

    log(f"[stage 2] {time.time() - t_start:.1f} s")

    # ---- 12-16. the radiance bake ------------------------------------------
    out_dir = sys.argv[sys.argv.index("--profile") + 1] \
        if "--profile" in sys.argv[1:-1] else None
    report.extend(run_bake(state, cam, opt, cfg, bg, card, dev, parents,
                           out_dir))

    # ---- 17-23. the tile-major paths (strip 0, sort binner) and B9 -------
    report.extend(run_tiles(
        state, cam, opt, cfg, bg, card, dev,
        step8=(step, (state, ost0, cam, 1.0, 1.6e-4)),
        s2=(s2_state, bake, env0, step2, s2_args), edge_calls=edge_calls,
        ptx=ptx, parents=parents, profile_dir=out_dir))

    if out_dir:
        profile_step(lambda: step(state, ost0, cam, 1.0, 1.6e-4), out_dir)
        profile_step(lambda: step2(*s2_args), out_dir,
                     "chip_smoke_profile_stage2.txt")
    log(f"[done] {time.time() - t_start:.1f} s")

    for entry in report:
        entry["launch_floor_device_ms"] = floor_ms
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
