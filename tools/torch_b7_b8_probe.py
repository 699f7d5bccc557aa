#!/usr/bin/env python3
"""What bounds B7's backward (``csrc/env_lookup.cu``) and B8, the grid march
(``csrc/march.cu``), on one CUDA card, on the bench scene's own inputs.

    python3 tools/torch_b7_b8_probe.py              # this tree's kernels
    python3 tools/torch_b7_b8_probe.py --tree DIR   # another checkout's
                                                    # (DIR/svgir_tpu_torch)

Inputs, as ``chip_smoke.py`` makes them: the bench scene (50,000 surfels),
the lookups of one stage-2 step at S = 24 (``bench_stage2.py``'s synthetic
bake) and of one S = 64 step on the real bake (the recipe's 32x64 env), and
the first 65,536-ray chunk of the S = 64 bake of the bench surfels (they
face outward: no ray hits) and of the same surfels turned inward.

B7's backward:
- the device time of each device operation of one call, by name
  (torch.profiler over 20 calls, as ``chip_smoke.device_ms``);
- the atomic instructions ``cuobjdump -sass`` shows in each of its kernels
  (a shared float add compiled to a native add or to a CAS loop);
- how often lanes of one atomic instruction meet: the share of queries
  whose first texel another lane of the same instruction also takes, and
  the mean of the most lanes one shared-memory bank serves in an
  instruction (32 consecutive queries a warp, and 4 queries a lane);
- variants of the source (``B7_VARIANTS``, one text substitution each),
  each timed on the device; a variant whose text is not in the source is
  skipped.

B8, on both chunks, over the block visits the walk needs (before a ray's
list is settled, as ``chip_smoke.march_work`` counts them):
- (a) how many candidates are real (not the padding past a cell's count)
  and pass the six-field prefilter (facing: the denominator's sign; the
  plane hit within the visit's t-span; fields 0-2 and 21-23), how many of
  those pass the ellipse test (dis <= 9, 8 more fields), how many are
  accepted; by candidate, by 32-candidate half-block and by 32-byte
  sector (8 lanes), with the bytes per visit each way of loading implies;
- (b) how many visits repeat a block that another ray of the same group
  of consecutive rays (4: one 128-thread block; 64: one surfel's rays)
  visits;
- (c) variants of the source (``B8_VARIANTS``): of the one-pass kernel
  (all 23 fields loaded for one test) the fields loaded and summed
  without the test, only the six prefilter fields, no fields; of this one, other numbers of rays a block and of
  warps an SM, the walk alone, and the first two stages of the test as
  one.

Prints the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SUM23 = ("(SVGIR_F(0) + SVGIR_F(1) + SVGIR_F(2) + SVGIR_F(3) + SVGIR_F(4) + "
          "SVGIR_F(6) + SVGIR_F(7) + SVGIR_F(9) + SVGIR_F(10) + SVGIR_F(12) + "
          "SVGIR_F(13) + SVGIR_F(15) + SVGIR_F(16) + SVGIR_F(17) + "
          "SVGIR_F(18) + SVGIR_F(19) + SVGIR_F(20) + SVGIR_F(21) + "
          "SVGIR_F(22) + SVGIR_F(23) + SVGIR_F(24) + SVGIR_F(25) + "
          "SVGIR_F(26))")
_SUM6 = ("(SVGIR_F(0) + SVGIR_F(1) + SVGIR_F(2) + SVGIR_F(21) + SVGIR_F(22) "
         "+ SVGIR_F(23))")
# the one-pass kernel's test (all 23 fields loaded at once) ends in this
# statement
_ONE_PASS_RETURN = ("  return id >= 0 && SVGIR_F(25) > 0.5f && dis <= 9.f && "
                    "power <= 0.f &&\n         alpha >= SVGIR_MARCH_ALPHA_MIN && "
                    "denom_raw < 0.f && t >= t_lo && t < t_hi;")

_ADD = "atomicAdd(s + at[i], x[i]);"
_WADD = "if (on) s[at[i]] = __fadd_rn(s[at[i]], x[i]);"
_WSYNC = "    __syncwarp();\n  }\n}\n"
_ALONE = "const bool alone = valid && tag[tex[k]] == lane;"
_ANY = "  if (!__any_sync(SVGIR_MARCH_FULL, live[0] || live[1])) return;\n"
_MIN = "KPL == 1 ? 12 : KPL == 2 ? 8 : 4"

# name -> [(text in the source, replacement)]
B7_VARIANTS = {
    "as is": [],
    "partial-sum kernel, plain adds in place of its atomics (wrong sums)": [
        ('#include "blend_common.cuh"\n',
         '#include "blend_common.cuh"\n#define atomicAdd(p, x) (*(p) += (x))\n'),
        ("svgir_env_bwd_partial_kernel<<<", "svgir_env_bwd_partial_kernel<<<")],
    "plain adds in place of the atomics (wrong sums)": [
        (_ADD, "s[at[i]] += x[i];")],
    "no adds (the loads and the flush alone)": [
        (_ADD, "if (x[i] == 1.2345e-30f) s[at[i]] = x[i];"),
        (_WADD, "if (on && x[i] == 1.2345e-30f) s[at[i]] = x[i];"),
        ("    else if (shared) atomicAdd(s + at[i], x[i]);\n", "")],
    "no barriers between a warp's taps": [(_WSYNC, "  }\n}\n")],
    "no texel tags (wrong where lanes share a first texel)": [
        (_ALONE, "const bool alone = valid;")],
}
B8_VARIANTS = {
    "as is": [],
    "16 rays a block": [("kMarchThreads = 128;", "kMarchThreads = 512;"),
                        (_MIN, "KPL == 1 ? 3 : KPL == 2 ? 2 : 1")],
    "32 warps an SM": [(_MIN, "KPL == 1 ? 8 : KPL == 2 ? 8 : 4")],
    "64 warps an SM": [(_MIN, "KPL == 1 ? 16 : KPL == 2 ? 8 : 4")],
    "the walk alone (the test dead code)": [(_ANY, "  return;\n"),
                                            (_MIN, _MIN)],
    "facing and span as one stage": [
        ("    live[h] = denom_raw < 0.f;\n  }\n" + _ANY,
         "    live[h] = denom_raw < 0.f;\n  }\n")],
    "one-pass kernel, fields loaded and summed, no test": [
        (_ONE_PASS_RETURN, f"  return {_SUM23} == 1.2345e-30f;")],
    "one-pass kernel, the six prefilter fields only": [
        (_ONE_PASS_RETURN, f"  return {_SUM6} == 1.2345e-30f;")],
    "one-pass kernel, no fields (the walk and the visits)": [
        (_ONE_PASS_RETURN, "  return ox == 1.2345e-30f;")],
}


def log(*a):
    print(*a, flush=True)


def by_name(fn, reps=20):
    """{device operation: ms per call} of ``reps`` calls of fn."""
    import math
    import time

    import torch
    from torch.autograd import DeviceType
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
    acc = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            n_us = acc.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    return {k: us / n * math.ceil(n / reps) / 1e3
            for k, (n, us) in acc.items()}


def build_variants(stem, variants, tag):
    """Copies of csrc/<stem>.cu with each variant's substitutions, built
    with nvcc in parallel into _build/probe/; returns {name: CDLL} of those
    whose text was found and which built."""
    from svgir_tpu_torch.kernels import build
    src = (build.CSRC_DIR / f"{stem}.cu").read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        s = src
        missing = [old for old, _ in subs if old not in s]
        if missing:
            log(f"[probe] {tag} variant {name!r}: skipped (its text is not in "
                f"{stem}.cu)")
            continue
        for old, new in subs:
            s = s.replace(old, new)
        base = f"{tag}_" + "".join(c if c.isalnum() else "_" for c in name)
        cu, lib = out_dir / f"{base}.cu", out_dir / f"lib{base}.so"
        cu.write_text(s)
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            log(f"[probe] {tag} variant {name!r}: nvcc failed:\n{text[-2000:]}")
            continue
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def use_library(wrapper_mod, lib):
    """Point a wrapper module's entry points at ``lib``."""
    def entry(stem, name, argtypes):
        f = getattr(lib, name)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f
    wrapper_mod.entry = entry


def sass_atomics(stem):
    """{kernel: Counter of atomic opcodes} of the built csrc/<stem>.cu."""
    from svgir_tpu_torch.kernels import build
    lib = build.build()[stem]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG|REDUX)\.[\w.]*|"
                      r"(?:ATOMS|ATOMG|ATOM|RED|REDG))\b", line)
        if m and fn:
            out[fn][m.group(1)] += 1
    return out


def env_meetings(u, v, h, w):
    """Lanes of one atomic instruction: share of queries whose first texel
    another lane also takes, and the mean most lanes one bank serves, for
    32 consecutive queries a warp and for 4 queries a lane (lane l of a
    warp's group holds queries 4l .. 4l+3)."""
    import torch

    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    su, _ = EP._taps(u, w)
    sv, _ = EP._taps(v, h)
    base = sv * w + su
    out = {}
    for label, groups in (("32 consecutive", 32), ("4 per lane", 128)):
        m = base.numel() // groups * groups
        b = base[:m].reshape(-1, groups)
        if groups == 128:       # [G, 32 lanes, 4] -> one instruction per k
            b = b.reshape(-1, 32, 4).transpose(1, 2).reshape(-1, 32)
        srt, _ = torch.sort(b, 1)
        dup = torch.zeros_like(srt, dtype=torch.bool)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup[:, :-1] |= srt[:, :-1] == srt[:, 1:]
        banks = (b * 3) % 32        # channel 0 of tap (0, 0)
        cnt = torch.zeros(b.shape[0], 32, dtype=torch.int32, device=b.device)
        cnt.scatter_add_(1, banks, torch.ones_like(banks, dtype=torch.int32))
        out[label] = (float(dup.float().mean()),
                      float(cnt.max(1).values.float().mean()))
    return out


def march_stats(grid, o, d, t, *, t_max, n_steps, kmax, k, batch=65_536):
    """(a) and (b) of the module docstring on one chunk."""
    import torch

    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import tracing as TR
    dev = o.device
    nb, spans, cells = GT._run_scan(grid, o, d, n_steps=n_steps, kmax=kmax)
    dt = GT.grid_dt(grid)
    j = torch.arange(n_steps, device=dev)
    t_lo_j = j.to(torch.float32) * dt
    kth = torch.where(torch.isfinite(t[:, k - 1]), t[:, k - 1],
                      torch.full_like(t[:, 0], float("inf")))
    late = (nb > 0) & ~(t_lo_j[None] < kth[:, None])
    stop = torch.where(late.any(1), late.to(torch.int32).argmax(1),
                       torch.full_like(j[:1], n_steps).expand(len(o)))
    needed = (nb > 0) & (j[None] < stop[:, None])
    ray, step = torch.nonzero(needed, as_tuple=True)
    nbv = nb[ray, step].long()
    ray = torch.repeat_interleave(ray, nbv)
    step = torch.repeat_interleave(step, nbv)
    first = torch.cumsum(nbv, 0) - nbv
    bi = torch.arange(int(nbv.sum()), device=dev) - \
        torch.repeat_interleave(first, nbv)
    cell = cells[ray, step].long()
    row = grid.block_start[cell].long() + bi
    cnt = torch.clamp(grid.cell_count[cell], max=grid.cell_cap).long()
    span = spans[ray, step]
    t_lo = step.to(torch.float32) * dt
    t_hi = torch.minimum((step + span).to(torch.float32) * dt,
                         torch.tensor(t_max, device=dev))
    nv = row.numel()
    lane = torch.arange(64, device=dev)
    tot = Counter()
    geo3 = grid.block_geo.view(-1, 32, 64)
    for b0 in range(0, nv, batch):
        sl = slice(b0, min(b0 + batch, nv))
        rows = geo3[row[sl]].transpose(1, 2)                # [B, 64, 32]
        real = lane[None] < (cnt[sl] - bi[sl] * 64)[:, None]
        tp, dis, power, alpha, facing, _, _ = TR.surfel_test(
            rows[..., 0:3], rows[..., 21:24],
            rows[..., 6:15].reshape(rows.shape[:-1] + (3, 3)),
            rows[..., 3:6], rows[..., 15:21], rows[..., 24],
            o[ray[sl]][:, None], d[ray[sl]][:, None])
        face = real & facing
        pre = face & (tp >= t_lo[sl, None]) & (tp < t_hi[sl, None])
        ell = pre & (dis <= 9.0)
        acc = GT._test_candidates(rows, o[ray[sl]], d[ray[sl]], t_lo[sl],
                                  t_hi[sl])["ok"]
        for name, x in (("real", real), ("face", face), ("pre", pre),
                        ("ell", ell), ("acc", acc)):
            tot[name] += int(x.sum())
            tot[name + "_half"] += int(x.view(-1, 2, 32).any(2).sum())
            tot[name + "_sector"] += int(x.view(-1, 8, 8).any(2).sum())
    reuse = {}
    for g in (4, 64):
        key = (ray // g) * (grid.block_geo.shape[0] + 1) + row
        reuse[g] = 1.0 - torch.unique(key).numel() / max(nv, 1)
    return nv, tot, reuse


def main() -> int:
    args = sys.argv[1:]
    tree = os.path.abspath(args[args.index("--tree") + 1]) \
        if "--tree" in args else ROOT
    sys.path.insert(0, ROOT)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("torch_b7_b8_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import svgir_tpu_torch
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.kernels import build
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.kernels import march as KM
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.train import optim, trainer

    card = CS.nvidia_smi()
    log(f"[probe] tree {os.path.dirname(svgir_tpu_torch.__file__)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; card: {card}")
    build.build()
    fn = None
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("env_bwd" in fn or "march" in fn) and (
                "registers" in line or "spill" in line):
            log(f"[ptxas] {fn}: {line.strip()}")
    dev = "cuda"
    state, cam = CS.bench_scene(dev)
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    cfg = RasterConfig(max_instances=165_888)

    # ---- inputs: the S = 24 step, the S = 64 bake and step, the inward bake
    s2_state, bake24, env24 = CS.stage2_inputs(state, dev)
    lrs = optim.group_lrs(opt, 1.0, use_pbr=True)
    step = trainer.make_svgss_train_step(opt, cfg, bg, lrs=lrs, device=dev)
    with CS.Capture() as c24:
        step({**s2_state, "stats": state["stats"]},
             optim.adam_init(s2_state["params"]), env24, bake24, cam, 100.0,
             1e-5, opt.radiance_lr)
    p = state["params"]
    inputs = (p["xyz"], G.get_scaling(p), G.get_rotation(p),
              G.get_opacity(p)[:, 0], G.get_shs(p))
    az = torch.rand(p["xyz"].shape[0], 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    with CS.Recorder(GT, "nearest_hits_grid") as r_out:
        bake64 = RAD.bake_radiance(*inputs, sample_num=64, azimuth=az)
    bake64 = {x: v for x, v in bake64.items() if x != "exhausted_frac"}
    pbr = G.upgrade_to_pbr(state)
    prm = dict(pbr["params"])
    prm["radiances"] = bake64["radiance"].clone()
    prm["radiance_ratio"] = torch.ones((), device=dev)
    env64 = LT.direct_light_map_init(32, opt.light_init, generator=torch.
                                     Generator(device=dev).manual_seed(2),
                                     device=dev)
    with CS.Capture() as c64:
        step({**pbr, "params": prm, "stats": state["stats"]},
             optim.adam_init(prm), env64, bake64, cam, 1.0, 1e-5,
             opt.radiance_lr)
    in_state, _ = CS.bench_scene(dev, inward=True)
    pi_ = in_state["params"]
    with CS.Recorder(GT, "nearest_hits_grid") as r_in:
        RAD.bake_radiance(pi_["xyz"], G.get_scaling(pi_), G.get_rotation(pi_),
                          G.get_opacity(pi_)[:, 0], G.get_shs(pi_),
                          sample_num=64, azimuth=az)
    torch.cuda.synchronize()

    # ---- B7's backward -------------------------------------------------
    for fn, ops in sorted(sass_atomics("env_lookup").items()):
        if "bwd" in fn or "backward" in fn:
            log(f"[B7 sass] {fn}: " + (", ".join(
                f"{op} x{n}" for op, n in sorted(ops.items())) or
                "no atomic instruction"))
    b7 = {}
    for label, cap in (("S = 24", c24), ("S = 64", c64)):
        (u, v, g), kw = cap.calls["env_lookup_backward"]
        b7[label] = (u, v, g, kw)
        meet = env_meetings(u, v, kw["h"], kw["w"])
        log(f"[B7 meetings] {label} ({u.numel()} queries, env {kw['h']}x"
            f"{kw['w']}): " + "; ".join(
                f"{k}: {a:.4f} of the queries share their first texel with "
                f"another lane of the instruction, {b:.2f} lanes on the "
                "busiest bank" for k, (a, b) in meet.items()))
        split = by_name(lambda: KE.env_lookup_backward(u, v, g, **kw))
        log(f"[B7 split] {label}: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in split.items())
            + f" (sum {sum(split.values()):.4f}); card: {card}")
    wide = CS.kernel_inputs().env_lookup_inputs(128, 256, 3, 20_003)
    uw, vw = (torch.from_numpy(x).to(dev) for x in wide[1:3])
    gw = torch.from_numpy(wide[3]).to(dev)
    b7["env 128x256, M 20,003"] = (uw, vw, gw, dict(h=128, w=256))
    libs = build_variants("env_lookup", B7_VARIANTS, "b7")
    # this tree's routes: a copy a warp where it takes it, or a copy a block
    default = getattr(KE, "BWD_WARP_COPIES", None)
    routes = {"": default}
    if default is not None:
        routes[", one copy a block (shared atomics)"] = 10 ** 9
    for (name, lib), (route, copies) in (
            (x, r) for x in libs.items() for r in routes.items()
            if x[0] == "as is" or not r[0]):
        use_library(KE, lib)
        if copies is not None:
            KE.BWD_WARP_COPIES = copies
        for label, (u, v, g, kw) in b7.items():
            pb = EP.env_lookup_backward_plain(u, v, g, **kw)
            kb = KE.env_lookup_backward(u, v, g, **kw)
            err = float((kb - pb).abs().max()) / float(pb.abs().max())
            t = [CS.device_ms(lambda: KE.env_lookup_backward(
                u, v, g, **kw))[0] for _ in range(3)]
            log(f"[B7 variant] {name}{route}, {label}: device "
                + " / ".join(f"{x:.4f}" for x in t) + f" ms; max|err| "
                f"{err:.3g} of max |d_env|; card: {card}")

    if default is not None:
        KE.BWD_WARP_COPIES = default

    # ---- B8 --------------------------------------------------------------
    chunks = {}
    for label, rec in (("no-hit chunk", r_out), ("inward chunk", r_in)):
        (geo, grid, o, d), hkw, _, _ = rec.calls[0]
        mkw = dict(t_max=hkw["t_max"], k=hkw["k"], n_steps=hkw["n_steps"],
                   kmax=GT._run_kmax(grid))
        with torch.no_grad():
            t_p, i_p = MP.march_plain(grid, o, d, **mkw)
        chunks[label] = (grid, o, d, mkw, t_p, i_p)
        nv, tot, reuse = march_stats(grid, o, d, t_p, **mkw)
        half, sect = 2 * nv, 8 * nv
        log(f"[B8 (a)] {label}: {len(o)} rays, {nv} needed block visits, "
            f"grid res {grid.res}, cap {grid.cell_cap}")
        for name, what in (("real", "real (not padding)"),
                           ("face", "face the ray"),
                           ("pre", "pass the six-field prefilter"),
                           ("ell", "then the ellipse test (dis <= 9)"),
                           ("acc", "are accepted")):
            log(f"[B8 (a)]   {what}: {tot[name] / (64 * nv):.4f} of the "
                f"candidates, {tot[name + '_half'] / half:.4f} of the "
                f"half-blocks hold one, {tot[name + '_sector'] / sect:.4f} "
                "of the 32-byte sectors")
        full = 23 * 256
        lazy = 32 * (6 * tot["real_sector"] + 8 * tot["pre_sector"]
                     + 9 * tot["ell_sector"]) / nv
        lazy4 = 32 * (3 * tot["real_sector"] + 3 * tot["face_sector"]
                      + 8 * tot["pre_sector"] + 9 * tot["ell_sector"]) / nv
        log(f"[B8 (a)]   bytes per visit: {full} loading the 23 fields of "
            f"all 64 candidates; {lazy:.0f} loading the six prefilter fields"
            " of the sectors holding a real candidate, the 8 ellipse fields "
            "of those holding a prefilter pass, the other 9 of those "
            f"passing the ellipse test; {lazy4:.0f} loading the three "
            "normal fields first, then the three mean fields of the sectors "
            "holding a candidate that faces the ray")
        log(f"[B8 (b)]   {label}: share of visits whose block another ray "
            "of the same group visits too: "
            + ", ".join(f"groups of {g} rays {x:.4f}"
                        for g, x in reuse.items()))
    libs = build_variants("march", B8_VARIANTS, "b8")
    for name, lib in libs.items():
        use_library(KM, lib)
        for label, (grid, o, d, mkw, t_p, i_p) in chunks.items():
            with torch.no_grad():
                kt, ki = MP.march(grid, o, d, **mkw)
            same = torch.equal(ki, i_p) and torch.equal(
                torch.isfinite(kt), torch.isfinite(t_p))
            t = [CS.device_ms(lambda: MP.march(grid, o, d, **mkw),
                              reps=5)[0] for _ in range(3)]
            log(f"[B8 (c)] {name}, {label}: device "
                + " / ".join(f"{x:.4f}" for x in t)
                + f" ms; hits equal to march_plain: {same}; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
