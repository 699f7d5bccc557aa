"""The benchmark's harness: cells found by name, the inputs made from the
seed, the program's training loop driven through a timed window, the
profiler's trace reduced to per-layer readings, and the comparison with the
plain reference that decides ``correct``.

Everything one configuration, traffic mix or per-layer metric needs sits
in files of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix, limits and the metrics it reports:
    {"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"}.  Raises KeyError for a name the file does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    bdir = root / "benchmark"
    config = load_json(bdir / "configs" / f"{w['config']}.json")
    config["name"] = w["config"]
    traffic = load_json(bdir / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]

    def reported(m):
        return workload in m.get("workloads", [workload])

    return {
        "workload": w, "config": config, "traffic": traffic,
        "limits": load_json(bdir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
        "per_layer": [m for m in bench["per_layer"] if reported(m)],
        "bench_dir": bdir,
    }
