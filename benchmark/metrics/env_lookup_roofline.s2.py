"""The env lookup kernel's (B7, forward and backward) share of its
roofline in the traced stage-2 steps: one lookup of every bake query a
step (``work.env_bounds``) over the kernels' device time in the trace."""


def read(ctx):
    t, wk = ctx.get("trace"), ctx.get("work")
    if t is None or wk is None or ctx["stage"] != 2:
        return None
    dev_s = (t.kernel_s["env_lookup_forward"]
             + t.kernel_s["env_lookup_backward"])
    if dev_s <= 0:
        return None
    return 100.0 * wk["env_bound_s_per_step"] * t.steps / dev_s
