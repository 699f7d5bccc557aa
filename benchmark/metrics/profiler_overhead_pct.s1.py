"""The profiler's host cost on a stage-1 step: the traced window's time a
step over the timed window's, less one.  The profiler adds a fixed cost to
each operation the host dispatches, so on a host-bound step this grows
with the operations a step dispatches."""


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("window")
    if t is None or w is None or ctx["stage"] != 1 or w["steps"] == 0:
        return None
    traced = t.window_s / t.steps
    timed = w["seconds"] / w["steps"]
    return 100.0 * (traced / timed - 1.0)
