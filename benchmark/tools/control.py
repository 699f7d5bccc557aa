"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size.

    python3 benchmark/tools/control.py --workload syn4_512.s2_sphere_bake \\
        --seeds 11,12,13 [--control-seeds 11,12,13] \\
        [--faults unchanged,half_batch] [--fault-seeds 11,12,13]

For each seed: the program's set-up and its checked steps, the reference's
on the same inputs, and the three numbers of ``benchlib.check`` (the
lower reading is the largest over the seeds).  For each control seed: the
reference computed in TF32 (the precision below the configuration's
float32 with TF32 off) put in the program's place.  For each planted fault
(``benchlib.faults``) and fault seed: the program with the fault.  One
JSON line per reading, then a summary line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]



def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)

    import torch

    from benchlib import check, faults, load_cell
    from benchlib.training import Program, Reference

    cell = load_cell(args.workload)
    stage = cell["traffic"]["stage"]
    dev = torch.device("cuda:0")
    n = 3
    refs = {}

    def reference(seed, tf32=False):
        key = (seed, tf32)
        if key not in refs:
            r = Reference(cell, seed, dev, stage, tf32=tf32)
            refs[key] = r.checked_steps(n).as_dict()
            del r
            torch.cuda.empty_cache()
        return refs[key]

    def program(seed, fault=None):
        if fault:
            with faults.planted(fault):
                p = Program(cell, seed, dev, stage)
                out = p.checked_steps(n).as_dict()
        else:
            p = Program(cell, seed, dev, stage)
            out = p.checked_steps(n).as_dict()
        p.free()
        del p
        torch.cuda.empty_cache()
        return out

    def emit(kind, seed, side, t0):
        g = check.gaps(side, reference(seed))
        line = {"kind": kind, "seed": seed, "s": time.time() - t0,
                "program": side, "reference": reference(seed),
                **{k: g[k] for k in
                   check.NUMBERS + ("grad_leaf", "change_leaf")},
                "losses": side["losses"]}
        print(json.dumps(line), flush=True)
        return g

    summary = {}
    for s in args.seeds:
        t0 = time.time()
        g = emit("program", s, program(s), t0)
        for k in check.NUMBERS:
            summary.setdefault(f"program_max_{k}", 0.0)
            summary[f"program_max_{k}"] = max(summary[f"program_max_{k}"],
                                              g[k])
    for s in args.control_seeds:
        t0 = time.time()
        from reference.steps import set_tf32
        g = emit("control_tf32", s, reference(s, tf32=True), t0)
        set_tf32(False)
        for k in check.NUMBERS:
            key = f"control_min_{k}"
            summary[key] = min(summary.get(key, float("inf")), g[k])
    for f in [x for x in args.faults.split(",") if x]:
        for s in args.fault_seeds:
            t0 = time.time()
            g = emit(f"fault_{f}", s, program(s, f), t0)
            for k in check.NUMBERS:
                key = f"fault_{f}_min_{k}"
                summary[key] = min(summary.get(key, float("inf")), g[k])
    print(json.dumps({"summary": summary,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
