"""The traced window: ``torch.profiler`` over a fixed number of the loop's
iterations, reduced to the device's busy time, the device time of each
operation by name, the idle gaps with what the host was doing in each,
and the records' completeness against the program's own launch counters
(``svgir_tpu_torch.kernels.LAUNCHES``).

The card's profiler may drop device records late in a process, so each
operation's time is counted by name: its mean duration over the records
it has, times its launches.  For the program's own kernels the launches
are the counters'; other operations count the records they have.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

# The program's kernel counters (``kernels.LAUNCHES`` keys) and the
# device kernel names each one launches.
KERNELS = {
    "blend_forward": ("svgir_blend_fwd_kernel",),
    "blend_backward": ("svgir_blend_bwd_kernel",),
    "env_lookup_forward": ("svgir_env_fwd_kernel",),
    "env_lookup_backward": ("svgir_env_bwd_warps_kernel",
                            "svgir_env_bwd_kernel"),
    "binning_counts": ("svgir_counts_chunk_kernel",
                       "svgir_counts_scan_kernel"),
    "binning_instances": ("svgir_instances_kernel",),
}


def kernel_of(name: str):
    """The counter whose kernels include the device operation ``name``
    (a demangled template name), or None."""
    for counter, kernels in KERNELS.items():
        if any(k in name for k in kernels):
            return counter
    return None


class TracedWindow:
    """Run ``steps`` iterations of ``step()`` under the profiler and reduce
    the trace.  Attributes after ``run``: ``window_s`` (the window, from
    its first step's call to the synchronize that ends it), ``busy_s``
    (the union of device operations inside it, with the time of dropped
    records of the program's kernels added), ``ops`` ({name: seconds}),
    ``kernel_s`` ({counter: seconds}), ``launches`` ({counter: count}),
    ``recorded`` (share of the program's kernel launches recorded),
    ``gaps`` ([(host activity, seconds)], longest first)."""

    def __init__(self, steps: int):
        self.steps = steps

    def run(self, step: Callable[[], object], launches: Callable[[], Dict],
            cuda: bool = True):
        """``cuda=False`` (the CPU tests) takes the host's ``aten::``
        operations for the device's."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        sync = torch.cuda.synchronize if cuda else (lambda: None)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        sync()
        before = dict(launches())
        with profile(activities=acts) as prof:
            time.sleep(0.02)
            with record_function("benchmark.window"):
                for _ in range(self.steps):
                    with record_function("benchmark.step"):
                        step()
                sync()
            time.sleep(0.02)
        after = launches()
        self.launches = {k: after[k] - before.get(k, 0) for k in KERNELS}

        events = prof.events()
        win = [e for e in events if e.name == "benchmark.window"
               and e.device_type == DeviceType.CPU]
        if not win:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in events:
            if getattr(e, "is_user_annotation", False) and \
                    e.device_type == DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            on_device = e.device_type == DeviceType.CUDA if cuda else \
                e.name.startswith("aten::")
            if on_device:
                if b > w0 and a < w1:
                    dev.append((max(a, w0), min(b, w1), e.name))
            elif e.name not in ("benchmark.window",):
                host.append((a, b, e.name))
        if not dev:
            raise RuntimeError("the profiler recorded no device operation "
                               "in the window")
        dev.sort()
        self._reduce(dev, host, w0, w1)

    def _reduce(self, dev, host, w0, w1):
        by_name: Dict[str, List[float]] = {}
        for a, b, n in dev:
            by_name.setdefault(n, []).append((b - a) / 1e6)
        # kernels of the program: mean duration x launches
        recorded, expected = 0, 0
        self.kernel_s = {k: 0.0 for k in KERNELS}
        self.ops = {}
        dropped_s = 0.0
        per_counter: Dict[str, List[str]] = {}
        for n in by_name:
            c = kernel_of(n)
            if c is not None:
                per_counter.setdefault(c, []).append(n)
        for n, durs in by_name.items():
            self.ops[n] = sum(durs)
        for c, names in per_counter.items():
            n_rec = sum(len(by_name[n]) for n in names)
            total = sum(self.ops[n] for n in names)
            want = max(self.launches.get(c, 0), n_rec)
            self.kernel_s[c] = total / n_rec * want
            dropped_s += self.kernel_s[c] - total
            recorded += n_rec
            expected += want
        self.recorded = recorded / expected if expected else 1.0
        # the union of the device's intervals
        busy, end = 0.0, w0
        for a, b, _ in dev:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        self.busy_s = busy / 1e6 + dropped_s
        if self.busy_s > self.window_s:
            raise RuntimeError(
                f"the device's busy time {self.busy_s!r} s exceeds the "
                f"traced window's {self.window_s!r} s: dropped records "
                f"were counted too high")
        self.gaps = self._gaps(dev, host, w0, w1)

    @staticmethod
    def _gaps(dev, host, w0, w1, top: int = 10):
        """The longest idle intervals of the device inside the window, each
        named by the innermost host operation running at its middle."""
        idle, end = [], w0
        for a, b, _ in dev:
            if a > end:
                idle.append((end, a))
            end = max(end, b)
        if w1 > end:
            idle.append((end, w1))
        idle.sort(key=lambda ab: ab[0] - ab[1])
        out = []
        for a, b in idle[:top]:
            mid = 0.5 * (a + b)
            inner = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
            name = min(inner)[1] if inner else "host: between operations"
            out.append([name, (b - a) / 1e6])
        return out

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": self.gaps}
