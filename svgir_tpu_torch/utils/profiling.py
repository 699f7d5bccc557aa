"""Timing and profiling helpers, as ``svgir_tpu.utils.profiling`` offers
them: a ``Timing`` context manager (the reference's cudaEvent timer,
utils/system_utils.py:76-87), a ``torch.profiler`` trace region, a
pixels/s throughput meter for training loops and the device memory
counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class Timing:
    """Context manager: waits for the devices that ``result`` (a tensor or
    a dict, list or tuple of them) lies on, then records the wall ms.

    with Timing("raster") as t:
        out = render(...)
        t.result = out
    print(t.ms)
    """

    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.result = None
        self.ms = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for dev in {t.device for t in _tensors(self.result)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.ms = (time.perf_counter() - self.t0) * 1e3
        if self.verbose:
            print(f"[timing] {self.name}: {self.ms:.2f} ms", flush=True)
        return False


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` region; on exit its Chrome trace goes to
    ``logdir/trace.json`` (chrome://tracing, Perfetto).  It records the
    CUDA activity too where a card is there.  Yields the profiler, whose
    ``key_averages()`` tabulates it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ThroughputMeter:
    """EMA pixels/s + iterations/s counter for training loops."""

    def __init__(self, pixels_per_step: int, alpha: float = 0.1):
        self.pixels = pixels_per_step
        self.alpha = alpha
        self.ema_dt = None
        self.last = None

    def tick(self) -> Optional[Dict[str, float]]:
        now = time.perf_counter()
        if self.last is not None:
            dt = now - self.last
            self.ema_dt = dt if self.ema_dt is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema_dt)
        self.last = now
        if self.ema_dt is None:
            return None
        return {"iters_per_s": 1.0 / self.ema_dt,
                "pixels_per_s": self.pixels / self.ema_dt}


def device_memory_stats(device) -> Dict[str, int]:
    """The byte counters of ``torch.cuda.memory_stats(device)`` (allocated,
    reserved, active and inactive bytes, current and peak).  A CPU device
    keeps no such counters: it gives {}."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()
            if "bytes" in k}
