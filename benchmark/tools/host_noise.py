"""Where a cell's step time swings: the program's loop, as the timed window
drives it, run for ``--seconds`` in blocks of ``--block`` steps.  After
each block, with the device idle: a fixed host probe (a pure-Python loop,
its wall and CPU time), a fixed dispatch probe (small PyTorch operations
on the card, synchronized) and a fixed device probe (float32 matrix
products timed by CUDA events).  Beside them, per block: the main
thread's CPU time, the process's voluntary and involuntary context
switches, the CPU cores the main thread ran on, and the machine's steal
and idle shares from ``/proc/stat`` (these last read 0 on a machine whose
``/proc`` does not keep them).

    python3 benchmark/tools/host_noise.py --workload tensoir_800.s1_step \\
        --seed 5 --seconds 40 [--cpus 2]

``--cpus N`` pins the process to N fixed cores (the last N it may use)
before PyTorch starts.  One JSON line per block, then a summary line with
the correlation of each probe with the block's time a step.
"""

import argparse
import json
import os
import resource
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]


def proc_stat():
    """(steal, idle, total) jiffies over all cores of the machine."""
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    return v[7] if len(v) > 7 else 0, v[3] + v[4], sum(v)


def this_cpu() -> int:
    with open("/proc/thread-self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def host_probe():
    """(wall ms, the thread's CPU ms) of a fixed pure-Python loop."""
    t0, c0 = time.perf_counter(), time.thread_time()
    s = 0
    for i in range(200_000):
        s += i * i
    return ((time.perf_counter() - t0) * 1e3,
            (time.thread_time() - c0) * 1e3)


def corr(a, b):
    if len(a) < 3 or statistics.pstdev(a) == 0 or statistics.pstdev(b) == 0:
        return None
    ma, mb = statistics.fmean(a), statistics.fmean(b)
    cov = statistics.fmean([(x - ma) * (y - mb) for x, y in zip(a, b)])
    return cov / statistics.pstdev(a) / statistics.pstdev(b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--block", type=int, default=50)
    ap.add_argument("--cpus", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpus:
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[-args.cpus:])

    import torch

    from benchlib import load_cell
    from benchlib.training import Program

    cell = load_cell(args.workload)
    dev = torch.device("cuda:0")
    prog = Program(cell, args.seed, dev, cell["traffic"]["stage"])
    for _ in range(cell["traffic"]["warm_steps"]):
        prog.step()
    a = torch.randn(2048, 2048, device=dev)
    small = torch.zeros(16, device=dev)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def device_probe():
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(10):
            a @ a
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1)

    def dispatch_probe():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            small.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    device_probe(), dispatch_probe()
    rows = []
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        torch.cuda.synchronize()
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        st0, c0 = proc_stat(), time.thread_time()
        cpus = set()
        t0 = time.perf_counter()
        for _ in range(args.block):
            prog.step()
            cpus.add(this_cpu())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c1, st1 = time.thread_time(), proc_stat()
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        tot = max(st1[2] - st0[2], 1)
        probe_ms, probe_cpu_ms = host_probe()
        rows.append({
            "t": round(time.perf_counter() - (t_end - args.seconds), 2),
            "ms_a_step": wall / args.block * 1e3,
            "thread_cpu_ms_a_step": (c1 - c0) / args.block * 1e3,
            "invol_cs": r1.ru_nivcsw - r0.ru_nivcsw,
            "vol_cs": r1.ru_nvcsw - r0.ru_nvcsw,
            "cpus": sorted(cpus),
            "steal_pct": 100.0 * (st1[0] - st0[0]) / tot,
            "idle_pct": 100.0 * (st1[1] - st0[1]) / tot,
            "host_probe_ms": probe_ms,
            "host_probe_cpu_ms": probe_cpu_ms,
            "dispatch_probe_ms": dispatch_probe(),
            "device_probe_ms": device_probe(),
        })
        print(json.dumps(rows[-1]), flush=True)
    step = [r["ms_a_step"] for r in rows]
    summary = {"blocks": len(rows), "cpus_allowed": sorted(
        os.sched_getaffinity(0)), "ms_a_step_min": min(step),
        "ms_a_step_max": max(step)}
    for k in ("thread_cpu_ms_a_step", "invol_cs", "vol_cs", "steal_pct",
              "idle_pct", "host_probe_ms", "host_probe_cpu_ms",
              "dispatch_probe_ms", "device_probe_ms"):
        v = [r[k] for r in rows]
        summary[k] = {"min": min(v), "max": max(v), "corr": corr(step, v)}
    print(json.dumps({"summary": summary,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    prog.free()


if __name__ == "__main__":
    main()
