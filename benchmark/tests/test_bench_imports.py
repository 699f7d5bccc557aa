"""The import rule, by whole top-level names (the part before the first
dot): nothing the harness runs loads ``jax``, ``jaxlib``, ``flax`` or
``svgir_tpu`` (whose name ``svgir_tpu_torch`` begins with), and the
reference loads nothing of the program either."""

import ast
import json
import subprocess
import sys

from tinycell import BENCH, ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "svgir_tpu"}
PROGRAM = "svgir_tpu_torch"

RUN_TINY = """
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from svgir_tpu_torch.train import cap_probe
cap_probe.PROBE_CAP = 1 << 15
from pathlib import Path
from tinycell import make_tiny_root
from benchlib import run_cell
root = make_tiny_root(Path({tmp!r}))
rc = run_cell.main(["--workload", {workload!r}, "--seed", "3", "--seconds",
                    "0.3", "--trace", "1"], t_start=time.perf_counter(),
                   device=torch.device("cpu"), root=root)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

IMPORT_REFERENCE = """
import json, pkgutil, importlib, sys
sys.path.insert(0, {bench!r})
import reference
names = ["reference"]
for info in pkgutil.walk_packages(reference.__path__, "reference."):
    importlib.import_module(info.name)
    names.append(info.name)
print(json.dumps({{"loaded": sorted({{m.split(".")[0] for m in sys.modules}}),
                   "modules": names}}))
"""


def _top_modules(script: str):
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    for workload in ("tensoir_800.s1_step", "syn4_512.s2_sphere_bake"):
        tops = _top_modules(RUN_TINY.format(
            bench=str(BENCH), root=str(ROOT), tests=str(BENCH / "tests"),
            tmp=str(tmp_path / workload), workload=workload))
        assert PROGRAM in tops            # the program did run
        assert not JAX_NAMES & set(tops), sorted(JAX_NAMES & set(tops))


def test_the_reference_loads_nothing_of_the_program():
    out = _top_modules(IMPORT_REFERENCE.format(bench=str(BENCH)))
    assert len(out["modules"]) > 15
    assert not ({PROGRAM} | JAX_NAMES) & set(out["loaded"])


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_name_no_forbidden_module():
    """The harness's sources import no JAX module; the reference's import
    nothing of the program or of the harness."""
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = _imported_tops(path)
        assert not JAX_NAMES & tops, (path, JAX_NAMES & tops)
        if path.relative_to(BENCH).parts[0] == "reference":
            assert not {PROGRAM, "benchlib", "work"} & tops, (path, tops)


def test_prefix_is_not_whole_name():
    """The rule compares whole names: the program's own name passes."""
    from benchlib.run_cell import forbidden_modules
    assert PROGRAM.startswith("svgir_tpu")
    assert "svgir_tpu" not in [m.split(".")[0] for m in (PROGRAM,)]
    assert forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX_NAMES)
