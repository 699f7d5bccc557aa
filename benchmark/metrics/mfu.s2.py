"""The stage-2 step's share of the card's float32 peak: the float
operations the traced steps' views need (``work``, counted from the
inputs by the reference) over the timed window's time a step."""

import work


def read(ctx):
    w, wk = ctx.get("window"), ctx.get("work")
    if w is None or wk is None or ctx["stage"] != 2 or w["steps"] == 0:
        return None
    step_s = w["seconds"] / w["steps"]
    return 100.0 * wk["ops_per_step"] / step_s / work.FP32_OPS_S
