"""One run of one cell: set-up, the timed window, with ``--trace 1`` a
traced window, then the comparison with the plain reference, and the
result's line.  ``benchmark/run.py`` is the command."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List

from benchlib import BENCH_DIR, check, load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "svgir_tpu")
CHECKED_STEPS = 3
GIB = float(1 << 30)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def require_devices(chips: int):
    """The card the cell runs on; exits (code 3, no result) where
    PyTorch sees no CUDA device or fewer than the cell asks for."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s); PyTorch "
              f"sees {n}", file=sys.stderr)
        sys.exit(3)
    return torch.device("cuda:0")


def device_info(dev, chips: int) -> Dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": 0}


def _reader(bench_dir, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def view_order(n_views: int, first_it: int, steps: int, seed: int):
    """The view index of each iteration first_it+1 .. first_it+steps under
    the loop's camera schedule."""
    from reference.steps import camera_for_iter
    idx = list(range(n_views))
    return [camera_for_iter(idx, it, seed)
            for it in range(first_it + 1, first_it + steps + 1)]


def work_context(cell: Dict, seed: int, dev, views: List[int]) -> Dict:
    """The work the traced steps' views need, counted by the reference
    from the cell's inputs: the blend's least seconds (forward and
    backward, summed over the views), the env lookup's least seconds per
    step, and the step's float operations (mean over the views)."""
    import torch

    import work
    from benchlib import scene
    from reference.cameras import look_at_camera
    from reference.config import RasterConfig

    cfg = cell["config"]
    stage = cell["traffic"]["stage"]
    sur = scene.make_surfels(cfg, seed, dev)
    params, alive = sur["params"], sur["alive"]
    n_alive = int(alive.sum())
    eyes = scene.view_eyes(cfg, seed)
    res = cfg["resolution"]
    raster = RasterConfig(**{**cfg["raster"],
                             "max_instances": cfg["reference_slots"]})
    ca, cv = (14, 0) if stage == 1 else (13, 13)
    blend_s, ops, instances = 0.0, 0, []
    for i in views:
        cam = look_at_camera(eye=eyes[i].tolist(), target=[0.0, 0.0, 0.0],
                             up=[0.0, 0.0, 1.0], fovx=cfg["views"]["fov"],
                             fovy=cfg["views"]["fov"], width=res,
                             height=res, device=dev)
        wk = work.count_blend(params, alive, cam, raster)
        b = work.blend_bounds(wk, ca=ca, cv=cv, width=res, height=res,
                              tile=raster.tile)
        blend_s += b["forward_s"] + b["backward_s"]
        ops += b["ops"]
        instances.append(wk["instances"])
    # elements of a row that Adam updates: the stage-1 groups, and in
    # stage 2 the per-vertex normal offsets (12 for the 3 of stage 1), the
    # PBR groups and the baked radiances
    per_row = sum(v[0].numel() for v in params.values())
    if stage == 2:
        per_row += 9 + 12 + 4 + 48 + 16 + 3 * cfg["sample_num"]
    step_ops = (ops / len(views) + work.preprocess_ops(n_alive)
                + work.ssim_ops(res * res, 1 if stage == 1 else 2)
                + work.adam_ops(per_row * n_alive))
    env_s = 0.0
    if stage == 2:
        s = cfg["sample_num"]
        h = cfg["env_resolution"]
        e = work.env_bounds(cfg["rows"] * s, h, 2 * h)
        env_s = e["forward_s"] + e["backward_s"]
        step_ops += (e["ops"] + work.shading_ops(n_alive, s)
                     + work.consistency_ops(n_alive, s))
    del sur, params, alive
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return {"blend_bound_s": blend_s, "env_bound_s_per_step": env_s,
            "ops_per_step": step_ops, "instances": instances,
            "views": list(views)}


def main(argv=None, *, t_start: float, device=None, root=None) -> int:
    """``device`` and ``root`` (a checkout) stand in for the card and this
    checkout in the CPU tests."""
    args = build_parser().parse_args(argv)
    cell = load_cell(args.workload, *([root] if root else []))
    chips = cell["workload"]["chips"]
    dev = device if device is not None else require_devices(chips)

    import torch

    from benchlib.training import Program, Reference
    from svgir_tpu_torch import kernels

    stage = cell["traffic"]["stage"]
    prog = Program(cell, args.seed, dev, stage)
    prog_readings = prog.checked_steps(CHECKED_STEPS)
    for _ in range(cell["traffic"]["warm_steps"]):
        prog.step()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    first_window = len(prog.losses)
    host0 = prog.host_s
    t0 = time.perf_counter()
    while True:
        prog.step()
        if time.perf_counter() - t0 >= args.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    steps = len(prog.losses) - first_window
    host_s = prog.host_s - host0
    logs = [t for t in prog.log_times if t >= t0]
    log_ms = [(b - a) * 1e3 / prog.log_every for a, b in zip(logs, logs[1:])]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    traced = None
    if args.trace:
        from benchlib.trace import TracedWindow
        traced = TracedWindow(cell["traffic"]["trace_steps"])
        it_trace = prog.it
        traced.run(prog.step, kernels.launches, cuda=dev.type == "cuda")
    failed = prog.failed_steps(first_window)
    attempted = len(prog.losses) - first_window
    n_views = len(prog.cams)
    prog.free()
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = Reference(cell, args.seed, dev, stage)
    ref_readings = ref.checked_steps(CHECKED_STEPS)
    del ref
    ref_s = time.perf_counter() - t_ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    g = check.gaps(prog_readings.as_dict(), ref_readings.as_dict())
    verdict = check.judge(g, cell["limits"])

    info = device_info(dev, chips)
    info["memory_peak_bytes"] = int(peak)
    metrics = {}
    if not args.trace:
        step_name = f"s{stage}_step_ms"
        values = {step_name: window_s / steps * 1e3,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        views = view_order(n_views, it_trace, traced.steps, args.seed)
        ctx = {"stage": stage, "trace": traced,
               "window": {"steps": steps, "seconds": window_s,
                          "host_enqueue_s": host_s},
               "work": work_context(cell, args.seed, dev, views)}
        for m in cell["per_layer"]:
            v = _reader(cell["bench_dir"], m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        info["busy_s"] = traced.busy_s
        info["window_s"] = traced.window_s

    found = forbidden_modules()
    if found:
        print("benchmark: loaded modules of JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 4

    correct = verdict["ok"] and failed == 0
    detail = {"steps": steps, "window_s": window_s, "host_enqueue_s": host_s,
              "setup_s": setup_s, "reference_s": ref_s,
              "ms_a_step_between_log_reads": log_ms,
              "grad_gap_worst": g["grad_gap_worst"],
              "grad_leaf": g["grad_leaf"], "change_leaf": g["change_leaf"],
              "left_out_of_change": g["left_out"],
              "program": prog_readings.as_dict(),
              "reference": ref_readings.as_dict()}
    if traced is not None:
        detail.update(traced_steps=traced.steps,
                      profiler_recorded=traced.recorded,
                      launches=traced.launches, kernel_s=traced.kernel_s,
                      instances=ctx["work"]["instances"])
    print("benchmark detail: " + json.dumps(detail), file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = {**verdict["checks"],
                        "failed_steps": {"value": failed, "limit": 0}}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(t_start: float) -> None:
    cache = BENCH_DIR / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.exit(main(t_start=t_start))
