"""The program's own spans and counters, as the per-layer metrics read
them: the registry of ``svgir_tpu_torch.utils.profiling``, which records
only while a ``torch.profiler`` session records.  In a run of a cell the
profiler runs only in the traced window, so the registry holds that
window's steps and nothing else.

Each reader returns None where the cell runs another stage, where the
program has no registry (a checkout from before it had one) or recorded no
step, where the span is missing, and for device times where no CUDA event
was recorded (the CPU)."""

from __future__ import annotations

from typing import Dict, Optional


def summary(ctx: Dict, stage: int) -> Optional[Dict]:
    """The registry's summary, or None (see the module's docstring)."""
    if ctx.get("stage") != stage:
        return None
    try:
        from svgir_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "summary", None)
    if read is None:
        return None
    s = read()
    return s if s.get("steps") else None


def syncs_a_step(ctx: Dict, stage: int) -> Optional[float]:
    """Counter ``host_syncs`` charged inside ``svgir.step`` spans, a
    step."""
    s = summary(ctx, stage)
    if s is None:
        return None
    c = s["counters"].get("host_syncs", {"in_steps": 0})
    return c["in_steps"] / s["steps"]


def host_ms_a_step(ctx: Dict, stage: int, name: str) -> Optional[float]:
    """Host ms of span ``name`` a step."""
    s = summary(ctx, stage)
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["host_ms"] / s["steps"]


def device_ms_a_step(ctx: Dict, stage: int, *names: str) -> Optional[float]:
    """Device ms of spans ``names`` together a step: each span's interval
    on the stream, between the CUDA events at its entry and exit."""
    s = summary(ctx, stage)
    if s is None or any(n not in s["spans"] for n in names):
        return None
    ms = [s["spans"][n]["device_ms"] for n in names]
    if any(m is None for m in ms):
        return None
    return sum(ms) / s["steps"]
