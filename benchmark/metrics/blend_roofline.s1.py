"""The blend kernels' (B3 forward, B4 backward) share of their roofline
in the traced stage-1 steps: the least time their views' work needs
(``work.blend_bounds``, counted by the reference from the inputs) over
the kernels' device time in the trace."""


def read(ctx):
    t, wk = ctx.get("trace"), ctx.get("work")
    if t is None or wk is None or ctx["stage"] != 1:
        return None
    dev_s = t.kernel_s["blend_forward"] + t.kernel_s["blend_backward"]
    if dev_s <= 0:
        return None
    return 100.0 * wk["blend_bound_s"] / dev_s
