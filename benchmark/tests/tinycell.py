"""Helpers of the benchmark's CPU tests: a checkout-like tree whose cells
are cut to a CPU test's size, and one run of a cell there."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = {"resolution": 64, "rows": 4096, "alive": 2000, "sample_num": 4,
        "env_resolution": 8, "reference_slots": 1 << 16}


def make_tiny_root(dest: Path) -> Path:
    """A checkout-like tree under ``dest`` whose BENCHMARK.json names this
    benchmark's cells, with every configuration cut to a CPU test's size
    (64x64, 2,000 surfels in 4,096 rows, 5 views, S = 4, an 8x16 env)."""
    bdir = dest / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bdir / sub)
    for path in (bdir / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(TINY)
        c["views"]["count"] = 5
        c["scene"]["scale"] = [0.02, 0.05]
        path.write_text(json.dumps(c))
    for path in (bdir / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(trace_steps=2, warm_steps=1)
        path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def run_tiny(root: Path, workload: str, *, seed=5, seconds=0.5, trace=0,
             capsys=None):
    """``run_cell.main`` on the CPU in ``root``: (exit code, the result's
    line as a dict, or None)."""
    import time

    import torch

    from benchlib import run_cell
    rc = run_cell.main(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       t_start=time.perf_counter(),
                       device=torch.device("cpu"), root=root)
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return rc, line
