#!/usr/bin/env python3
"""Where B2 (``svgir_tpu_torch/csrc/binning.cu`` ``svgir_instances``) spends
its time on one CUDA card, on the bench scene's own inputs.

    python3 tools/torch_b2_probe.py      # from the repository root

It renders the bench scene of ``chip_smoke.py`` (800x800, 50,000 surfels,
tile 32, cap 165,888) and keeps B2's arguments, then builds copies of
``binning.cu`` with nvcc into ``svgir_tpu_torch/_build/probe/`` (git-ignored):

- phase clocks: thread 0 of every block stamps ``clock64()`` at the phase
  boundaries (load and scan, table, walk 1, per-tile counts, walk 2) and
  ``%globaltimer`` at its start and end; the fullest blocks are printed;
- variants: the source with one text substitution each (``VARIANTS``),
  each timed on the device (torch.profiler, as ``chip_smoke.device_ms``)
  three times, with whether it still equals ``instances_plain``.

Prints the card's name and power limit.  Needs one card; CPU-only
machines exit with an error.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> [(text in binning.cu, replacement)]: each variant is one idea
# taken out or changed
VARIANTS = {
    "as is": [],
    "load and scan only": [("  if (total == 0) return;",
                            "  if (total >= 0) return;")],
    "no walk 2": [("  for (int e0 = 0; e0 < total; e0 += kInstWindow) {",
                   "  for (int e0 = 0; e0 < 0; e0 += kInstWindow) {")],
    "256 threads": [("kInstThreads = 512;", "kInstThreads = 256;")],
    "1,024 threads": [("kInstThreads = 512;", "kInstThreads = 1024;")],
    "window 2,048": [("kInstWindow = 4096;", "kInstWindow = 2048;")],
}
PHASES = ("load and scan", "table", "walk 1", "per-tile counts", "walk 2")


def _stamp(k: int) -> str:
    return ("  if (threadIdx.x == 0) { long long ns_; asm volatile(\"mov.u64 "
            "%0, %%globaltimer;\" : \"=l\"(ns_)); g_clk[blockIdx.x * 8 + "
            f"{k}] = clock64(); g_clk[blockIdx.x * 8 + {6 if k == 0 else 7}]"
            " = ns_; }\n")


def _phase_source(src: str) -> str:
    """binning.cu with the phase stamps and a reader of them."""
    subs = [
        ("// B2.  Blocks [0, nwork)", "__device__ long long g_clk[4096 * 8];\n"
         "__device__ int g_tot[4096];\n// B2.  Blocks [0, nwork)"),
        ("  const int gc = gauss_chunk, ng", _stamp(0)
         + "  const int gc = gauss_chunk, ng"),
        ("  if (total == 0) return;", "  if (threadIdx.x == 0) "
         "g_tot[blockIdx.x] = total;\n" + _stamp(1)
         + "  if (total == 0) return;"),
        ("  // The per-Gaussian loops give", _stamp(2)
         + "  // The per-Gaussian loops give"),
        ("  // below[t][q] =", _stamp(3) + "  // below[t][q] ="),
        ("the window's map filled\n",
         "the window's map filled\n" + _stamp(4)),
    ]
    for a, b in subs:
        if a not in src:
            raise RuntimeError(f"phase stamp anchor not found: {a!r}")
        src = src.replace(a, b, 1)
    end = src.rindex("}", 0, src.index("// B1: counts [grid_x * grid_y]"))
    src = src[:end] + "  __syncthreads();\n" + _stamp(5) + src[end:]
    return src + ("\nextern \"C\" int probe_read(long long* clk, int* tot) {\n"
                  "  cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));\n"
                  "  return (int)cudaMemcpyFromSymbol(tot, g_tot, "
                  "sizeof(g_tot));\n}\n")


def _build(sources: dict) -> dict:
    from svgir_tpu_torch.kernels import build
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        stem = "".join(c if c.isalnum() else "_" for c in name)
        cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(src)
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_b2_probe: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as CS
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.ops import binning_pallas as P
    from svgir_tpu_torch.render.stage1 import render_view_stage1

    card = CS.nvidia_smi()
    state, cam = CS.bench_scene("cuda")
    with torch.no_grad(), CS.Capture() as cap:
        render_view_stage1(cam, state["params"], torch.zeros(3, device="cuda"),
                           alive=state["alive"],
                           cfg=RasterConfig(max_instances=165_888))
    a, kw = cap.calls["compute_instances"]
    ns, nt = a[0].numel(), a[6].shape[1]
    ps, pg = P.instances_plain(*a, **kw)
    with open(os.path.join(ROOT, "svgir_tpu_torch", "csrc",
                           "binning.cu")) as f:
        src = f.read()
    sources = {"phases": _phase_source(src)}
    for name, subs in VARIANTS.items():
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            s = s.replace(old, new)
        sources[name] = s
    libs = _build(sources)
    vp, vi = ctypes.c_void_p, ctypes.c_int
    slot = torch.empty(kw["m"], dtype=torch.int32, device="cuda")
    gid = torch.empty_like(slot)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        f = lib.svgir_instances
        f.argtypes = [vp] * 8 + [vi] * 5 + [vp] * 3
        f.restype = vi

        def call():
            rc = f(*[t.data_ptr() for t in a], ns, kw["m"], kw["gauss_chunk"],
                   kw["grid_x"], nt, slot.data_ptr(), gid.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"svgir_instances returned {rc}")
        return call

    print(f"[probe] B2 on the bench scene: {int(a[7])} instances, "
          f"{ns // kw['gauss_chunk']} chunks x {nt} tiles; card: {card}")
    call = launcher(libs["phases"])
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    clk = np.zeros(4096 * 8, np.int64)
    tot = np.zeros(4096, np.int32)
    libs["phases"].probe_read(clk.ctypes.data, tot.ctypes.data)
    nchunks = ns // kw["gauss_chunk"]
    clk, tot = clk.reshape(4096, 8)[:nchunks], tot[:nchunks]
    t0 = clk[:, 6].min()
    print("[probe] phase clocks (cycles) of the fullest blocks: "
          + ", ".join(PHASES) + "; start and end (ns after the first start)")
    for b in np.argsort(-tot, kind="stable")[:8]:
        c = clk[b]
        print(f"[probe]   chunk {b}: {tot[b]} instances: "
              + " / ".join(str(int(c[k + 1] - c[k])) for k in range(5))
              + f"; {int(c[6] - t0)} -> {int(c[7] - t0)} ns")
    empty = tot == 0
    if empty.any():
        print(f"[probe] {int(empty.sum())} chunks with no instance end after "
              f"the scan: {int(np.median(clk[empty, 1] - clk[empty, 0]))} "
              "cycles (median)")
    for name in VARIANTS:
        call = launcher(libs[name])
        slot.fill_(-2)
        gid.fill_(-2)
        call()
        torch.cuda.synchronize()
        same = torch.equal(slot, ps) and torch.equal(gid, pg)
        times = [CS.device_ms(call)[0] for _ in range(3)]
        print(f"[probe] {name}: device " + " / ".join(f"{t:.4f}" for t in times)
              + f" ms; equal to instances_plain: {same}; card: {card}")
    floor = CS.launch_floor()
    print(f"[probe] empty kernel: {CS.device_ms(floor)[0]:.4f} ms on the "
          f"device; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
