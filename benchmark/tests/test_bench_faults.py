"""The comparison that decides ``correct`` catches the faults a training
cell can have, planted underneath the timed path, in a whole run of the
harness (the look for a card skipped, the run on the CPU): a step that
returns its state unchanged, and half of a view's pixels left out of the
loss with the mean taken over the rest."""

import pytest

from tinycell import run_tiny

from benchlib import faults


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["tensoir_800.s1_step",
                                      "syn4_512.s2_sphere_bake"])
def test_a_planted_fault_reads_incorrect(tiny_root, capsys, fault, workload):
    with faults.planted(fault):
        rc, line = run_tiny(tiny_root, workload, capsys=capsys)
    assert rc == 0
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_sound_program_reads_correct(tiny_root, capsys):
    rc, line = run_tiny(tiny_root, "syn4_512.s2_sphere_bake", capsys=capsys)
    assert rc == 0 and line["correct"] is True
