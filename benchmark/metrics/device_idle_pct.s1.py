"""Share of the traced window of stage-1 steps in which no operation runs
on the device: one less the device's busy time (the profiler's device
records, dropped records of the program's kernels counted by its launch
counters) over the traced window, from its first step's call to the
synchronize that ends it.  The profiler's own host cost lengthens a
host-bound window; ``profiler_overhead_pct.s1`` reports it."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or ctx["stage"] != 1 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
