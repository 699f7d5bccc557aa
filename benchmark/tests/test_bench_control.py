"""On the card: the control, the reference computed in TF32 (the
precision below the configurations' float32 with TF32 off) put in the
program's place, reads incorrect against each cell's limits, while the
program reads correct, at a size a test run holds (256 x 256, 32,768
surfels in 65,536 rows, 10 views, S = 16).  ``tools/control.py`` takes
the same readings at the cells' own size."""

import json

import pytest

from benchlib import check, load_cell
from benchlib.training import Program, Reference

SIZE = {"resolution": 256, "rows": 65536, "alive": 32768,
        "sample_num": 16, "reference_slots": 1 << 20}


@pytest.mark.card
@pytest.mark.parametrize("workload,stage", [("tensoir_800.s1_step", 1),
                                            ("syn4_512.s2_sphere_bake", 2)])
def test_control_reads_incorrect_and_the_program_correct(card, tmp_path,
                                                         workload, stage):
    from tinycell import make_tiny_root
    root = make_tiny_root(tmp_path / "root")
    for path in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(SIZE)
        c["views"]["count"] = 10
        c["scene"]["scale"] = [0.006, 0.012]
        path.write_text(json.dumps(c))
    cell = load_cell(workload, root)
    limits = cell["limits"]
    for seed in (101, 102, 103):
        ref = Reference(cell, seed, card, stage).checked_steps(3).as_dict()
        ctl = Reference(cell, seed, card, stage,
                        tf32=True).checked_steps(3).as_dict()
        prog = Program(cell, seed, card, stage).checked_steps(3).as_dict()
        assert check.judge(check.gaps(prog, ref), limits)["ok"]
        assert not check.judge(check.gaps(ctl, ref), limits)["ok"]
