"""Host time of the stage-1 step call, from the call to its return and
before any synchronize, summed over the timed window and divided by its
steps: the share of a step the trainer loop and PyTorch's eager dispatch
hold the host."""


def read(ctx):
    w = ctx.get("window")
    if w is None or ctx["stage"] != 1 or w["steps"] == 0:
        return None
    return 1e3 * w["host_enqueue_s"] / w["steps"]
