"""The comparison that decides ``correct`` for a training cell.

Three numbers, each held to the cell's limit (``limits/<workload>.json``):

- ``loss_gap``: the largest relative gap between the program's loss and
  the reference's over the checked steps;
- ``grad_gap_median``: for each parameter group (leaf) that moves, the
  gap between the program's step-1 gradient norm and the reference's,
  measured against the reference's norm of that leaf or of the median
  leaf, whichever is larger; the median over those leaves.  (The worst
  leaf's gap, ``grad_gap_worst``, is read but not compared: it swings by
  its nature in both stages, where a handful of surfels seen near grazing
  hold most of the rotation leaf's gradient and float32 rounding is
  amplified; PERF.md has the look and the readings.)
- ``change_gap``: the same for the norm of each leaf's change over the
  checked steps, the worst leaf's, over the leaves that move: a leaf
  whose reference gradient is under ``MOVES`` of the median leaf's moves
  by round-off alone under Adam and is left out.
"""

from __future__ import annotations

import statistics
from typing import Dict

MOVES = 1e-3
COMPARED = ("loss_gap", "grad_gap_median", "change_gap")
NUMBERS = COMPARED + ("grad_gap_worst",)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys,
               med: float) -> Dict[str, float]:
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}
    return {k: float("inf") if v != v else v for k, v in gaps.items()}


def _worst(gaps: Dict[str, float]):
    if not gaps:
        return 0.0, None
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def gaps(prog: Dict, ref: Dict) -> Dict:
    """The three numbers (and the leaf that sets each) of the program's
    readings ``prog`` against the reference's ``ref``
    (``training.Readings.as_dict``)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    if any(a != a for a in prog["losses"]):       # NaN
        loss = float("inf")
    med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= MOVES * med]
    grads = _leaf_gaps(prog["grad"], ref["grad"], moving, med)
    grad_worst, grad_leaf = _worst(grads)
    grad = statistics.median(grads.values()) if grads else 0.0
    change, change_leaf = _worst(_leaf_gaps(
        prog["change"], ref["change"], moving,
        statistics.median(ref["change"][k] for k in moving)
        if moving else 0.0))
    return {"loss_gap": loss, "grad_gap_median": grad,
            "change_gap": change, "grad_gap_worst": grad_worst,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - set(moving))}


def judge(g: Dict, limits: Dict) -> Dict:
    """{name: {"value", "limit"}} of each compared number, and whether all
    lie within their limits (``ok``)."""
    checks = {k: {"value": g[k], "limit": limits[k]} for k in COMPARED}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"checks": checks, "ok": ok}
