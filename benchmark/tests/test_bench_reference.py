"""The plain reference agrees with the port's CPU path (its plain
versions) on a tiny stage-1 step and a tiny stage-2 step: the losses, the
step-1 gradient norms and the changes of every parameter group over three
steps, through the harness's own two sides."""

import pytest
import torch

from benchlib import check, load_cell
from benchlib.training import Program, Reference


@pytest.mark.parametrize("workload,stage", [("tensoir_800.s1_step", 1),
                                            ("syn4_512.s2_sphere_bake", 2)])
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, workload,
                                                   stage):
    cell = load_cell(workload, tiny_root)
    dev = torch.device("cpu")
    prog = Program(cell, 11, dev, stage).checked_steps(3).as_dict()
    ref = Reference(cell, 11, dev, stage).checked_steps(3).as_dict()
    assert set(prog["grad"]) == set(ref["grad"])
    for a, b in zip(prog["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=1e-6)
    for key in ("grad", "change"):
        for leaf, v in ref[key].items():
            assert prog[key][leaf] == pytest.approx(v, rel=1e-5, abs=1e-12)
    g = check.gaps(prog, ref)
    assert max(g["loss_gap"], g["grad_gap_median"], g["grad_gap_worst"],
               g["change_gap"]) < 1e-5
    # the groups the tiny step moves: every one with a gradient
    moved = [k for k, v in ref["change"].items() if v > 0]
    assert "opacity" in moved and len(moved) >= 5
