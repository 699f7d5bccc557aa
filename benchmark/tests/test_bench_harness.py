"""The harness on the CPU at a tiny size: the result's line, cells,
configurations, traffic mixes and metrics found by name as new files, and
the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

from tinycell import BENCH, ROOT, run_tiny

from benchlib import load_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_untraced(tiny_root, capsys):
    rc, line = run_tiny(tiny_root, "tensoir_800.s1_step", capsys=capsys)
    assert rc == 0
    assert list(line)[:5] == REQUIRED and list(line)[-1] == "checks"
    assert set(line) == set(REQUIRED) | {"checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"s1_step_ms", "peak_mem_gib", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_result_line_traced(tiny_root, capsys):
    rc, line = run_tiny(tiny_root, "syn4_512.s2_sphere_bake", trace=1,
                        capsys=capsys)
    assert rc == 0
    assert list(line)[:5] == REQUIRED and list(line)[-1] == "checks"
    assert set(line) == set(REQUIRED) | {"breakdown", "checks"}
    assert line["correct"] is True
    bd = line["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert 0 < len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    # no CUDA kernel ran: the kernels' rooflines find nothing to read
    names = set(line["metrics"])
    assert {"device_idle_pct.s2", "mfu.s2"} <= names
    assert not names & {"blend_roofline.s2", "env_lookup_roofline.s2"}
    assert not any(n.endswith(".s1") for n in names)


def test_new_files_are_found_by_name(tiny_root, capsys):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as new files, and entries in BENCHMARK.json, make a new cell that runs
    and reports the new metric; no existing file changes."""
    b = tiny_root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    shutil.copy(b / "configs" / "tensoir_800.json",
                b / "configs" / "tensoir_64.json")
    t = json.loads((b / "traffic" / "s1_steps.json").read_text())
    t["first_iteration"] = 16000
    (b / "traffic" / "s1_late.json").write_text(json.dumps(t))
    shutil.copy(b / "limits" / "tensoir_800.s1_step.json",
                b / "limits" / "tensoir_64.s1_late.json")
    (b / "metrics" / "window_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['steps'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "tensoir_64",
                             "file": "benchmark/configs/tensoir_64.json"})
    bench["workloads"].append({"name": "tensoir_64.s1_late",
                               "config": "tensoir_64", "traffic": "s1_late",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "s1_step_ms":
            m["workloads"].append("tensoir_64.s1_late")
    bench["per_layer"].append({
        "name": "window_steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "host: the trainer loop",
        "moves": "s1_step_ms", "workloads": ["tensoir_64.s1_late"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("tensoir_64.s1_late", tiny_root)
    assert cell["traffic"]["first_iteration"] == 16000
    assert cell["config"]["name"] == "tensoir_64"
    assert [m["name"] for m in cell["per_layer"]][-1] == "window_steps"
    rc, line = run_tiny(tiny_root, "tensoir_64.s1_late", trace=1,
                        capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["window_steps"]["value"] >= 1
    assert all(p.read_bytes() == data for p, data in before.items())


def _run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tensoir_800.s1_step", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_prints_no_result():
    """Without a CUDA device the command exits non-zero, printing nothing
    on standard output."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = _run_command(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and this folder (no
    program), the command exits non-zero with no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run_command(tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_busy_time_over_the_window_fails_the_run():
    """Dropped records counted so high that the device would be busy for
    longer than the traced window stop the run instead of being clipped."""
    import pytest

    from benchlib.trace import TracedWindow
    t = TracedWindow(1)
    t.window_s = 1e-3
    t.launches = {"blend_forward": 100}
    dev = [(0.0, 100.0, "svgir_blend_fwd_kernel<14, 0>")]   # 100 us
    with pytest.raises(RuntimeError, match="exceeds"):
        t._reduce(dev, [], 0.0, 1000.0)
    t.launches = {"blend_forward": 2}
    t._reduce(dev, [], 0.0, 1000.0)
    assert abs(t.busy_s - 2e-4) < 1e-12 and t.recorded == 0.5
