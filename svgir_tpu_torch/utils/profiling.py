"""The port's tracing: spans and counters inside the training step that
record only while a ``torch.profiler`` session records, and the profiler
window an operator opens over training iterations (``trace``,
``StepWindow``; ``cli/train.py --profile_steps``).

``span(name)`` marks one layer's forward work, as a context manager or a
decorator.  With no profiler recording it checks one flag and returns a
shared no-op.  While one records it enters
``torch.profiler.record_function(name)``, so the span sits in the
profiler's trace on the device records' clock, and keeps in memory its
name, its parent span, the step it belongs to, its host start and end
(``perf_counter_ns``) and, once CUDA is in use, a pair of CUDA events on
the current stream.  The events are resolved only when ``summary()`` is
read, never inside a step.

Autograd runs a layer's backward outside its forward span: ``mark =
layer(name)`` at the start of a layer's forward and ``layer_out(mark,
outputs)`` at its end put hooks, while the profiler records, on the
autograd nodes the layer made, which open ``<name>.bwd`` before the first
of them runs its backward and close it after the last.  Backward
Functions the port writes itself open a plain ``span`` inside their
backward.

``count(name, n)`` charges a counter to the innermost open span.
``svgir.step`` (``STEP``) counts ``steps`` and, on a CUDA device, every
point where the step's host waits for the device (``host_syncs``): the
step turns on ``torch.cuda.set_sync_debug_mode("warn")`` and counts its
warnings; the port's own synchronizes go through ``synchronize``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

STEP = "svgir.step"
SYNC_WARNING = "called a synchronizing CUDA operation"

_recording = torch._C._autograd._profiler_enabled


class _Record:
    """One span as it ran."""

    __slots__ = ("name", "parent", "step", "t0", "t1", "ev0", "ev1",
                 "counters", "handle", "syncs")

    def __init__(self, name, parent, step):
        self.name, self.parent, self.step = name, parent, step
        self.t0 = self.t1 = None
        self.ev0 = self.ev1 = None
        self.counters: Dict[str, int] = {}
        self.handle = None
        self.syncs = None


class _SyncWatch:
    """While a step runs: CUDA's sync debug mode on "warn", each of its
    warnings counted as one ``host_syncs`` of the innermost span, other
    warnings passed on.  ``close`` restores the mode and the filters."""

    def __init__(self, registry: "Registry"):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                if not registry.muted:
                    registry.count("host_syncs")
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")

    def close(self):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.filters.__exit__(None, None, None)


class Registry:
    """The spans and counters recorded while a profiler records.  One
    stack of open spans serves every thread: autograd's device thread
    opens a span inside ``svgir.backward`` while the step's thread waits
    there, and that span's parent is ``svgir.backward``.  A layer's
    ``.bwd`` span stays off the stack (it is nobody's parent and closes in
    its own order); one still open closes with its step."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        """Forget every span and counter (open spans are dropped)."""
        with self.lock:
            self.stack: List[_Record] = []
            self.marks: List[_Record] = []
            self.closed: List[_Record] = []
            self.loose: Dict[str, int] = {}
            self.steps = 0
            self.muted = False

    def open(self, name: str, mark: bool = False) -> _Record:
        handle = torch.profiler.record_function(name)
        handle.__enter__()
        with self.lock:
            parent = self.stack[-1] if self.stack else None
            if name == STEP:
                self.steps += 1
                step = self.steps
            else:
                step = parent.step if parent is not None else None
            rec = _Record(name, parent, step)
            (self.marks if mark else self.stack).append(rec)
        rec.handle = handle
        if name == STEP:
            rec.counters["steps"] = 1
            if torch.cuda.is_initialized():
                rec.syncs = _SyncWatch(self)
        if torch.cuda.is_initialized():
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record()
        rec.t0 = time.perf_counter_ns()
        return rec

    def close(self, rec: _Record):
        """Close ``rec``; one on the stack closes with every span above it
        that is still open, a step also with the ``.bwd`` spans still
        open."""
        if rec.t1 is not None:
            return
        with self.lock:
            if rec in self.stack:
                above = self.stack[self.stack.index(rec):]
                del self.stack[len(self.stack) - len(above):]
            else:
                above = [rec]
                if rec in self.marks:
                    self.marks.remove(rec)
            if rec.name == STEP:
                above, self.marks = self.marks + above, []
        for r in reversed(above):
            r.t1 = time.perf_counter_ns()
            if r.ev0 is not None:
                r.ev1 = torch.cuda.Event(enable_timing=True)
                r.ev1.record()
            if r.syncs is not None:
                r.syncs.close()
            r.handle.__exit__(None, None, None)
            with self.lock:
                self.closed.append(r)

    def count(self, name: str, n: int = 1):
        with self.lock:
            into = self.stack[-1].counters if self.stack else self.loose
            into[name] = into.get(name, 0) + n

    def summary(self) -> Dict:
        """Per span name: ``calls``, ``host_ms``, ``self_host_ms`` (less the
        time its child spans cover), ``device_ms`` and ``self_device_ms``
        (from the CUDA events: the span's interval on the stream; None
        where none was recorded) and ``counters`` (charged to it as the
        innermost span).  Per counter: ``total``, ``in_steps`` (charged
        inside a ``svgir.step``) and ``by_span``.  ``steps``: the closed
        step spans."""
        with self.lock:
            recs = list(self.closed)
            loose = dict(self.loose)
        timed = [r for r in recs if r.ev1 is not None]
        dev = {}
        if timed:
            torch.cuda.synchronize()
            origin = timed[0].ev0
            dev = {id(r): (origin.elapsed_time(r.ev0),
                           origin.elapsed_time(r.ev1)) for r in timed}
        host = {id(r): (r.t0 / 1e6, r.t1 / 1e6) for r in recs}
        children: Dict[int, List[_Record]] = {}
        for r in recs:
            if r.parent is not None:
                children.setdefault(id(r.parent), []).append(r)

        def self_ms(r, times):
            a, b = times[id(r)]
            kids = [times[id(c)] for c in children.get(id(r), [])
                    if id(c) in times]
            return (b - a) - _covered(kids, a, b)

        spans: Dict[str, Dict] = {}
        counters: Dict[str, Dict] = {}
        for r in recs:
            s = spans.setdefault(r.name, {
                "calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                "device_ms": None, "self_device_ms": None, "counters": {}})
            s["calls"] += 1
            a, b = host[id(r)]
            s["host_ms"] += b - a
            s["self_host_ms"] += self_ms(r, host)
            if id(r) in dev:
                a, b = dev[id(r)]
                s["device_ms"] = (s["device_ms"] or 0.0) + b - a
                s["self_device_ms"] = ((s["self_device_ms"] or 0.0)
                                       + self_ms(r, dev))
            for k, n in r.counters.items():
                s["counters"][k] = s["counters"].get(k, 0) + n
                c = counters.setdefault(k, {"total": 0, "in_steps": 0,
                                            "by_span": {}})
                c["total"] += n
                c["in_steps"] += n if r.step is not None else 0
                c["by_span"][r.name] = c["by_span"].get(r.name, 0) + n
        for k, n in loose.items():
            c = counters.setdefault(k, {"total": 0, "in_steps": 0,
                                        "by_span": {}})
            c["total"] += n
            c["by_span"][None] = c["by_span"].get(None, 0) + n
        steps = sum(1 for r in recs if r.name == STEP)
        return {"steps": steps, "spans": spans, "counters": counters}

    def records(self) -> List[Dict]:
        """The closed spans as they ran, in closing order."""
        with self.lock:
            recs = list(self.closed)
        index = {id(r): i for i, r in enumerate(recs)}
        origin = next((r.ev0 for r in recs if r.ev1 is not None), None)
        if origin is not None:
            torch.cuda.synchronize()
        out = []
        for r in recs:
            d = None if r.ev1 is None or origin is None else [
                origin.elapsed_time(r.ev0), origin.elapsed_time(r.ev1)]
            out.append({"name": r.name,
                        "parent": index.get(id(r.parent)),
                        "step": r.step, "host_ns": [r.t0, r.t1],
                        "device_ms": d, "counters": r.counters})
        return out


def _covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


REGISTRY = Registry()


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapper


class _Span:
    """A recording span, made per entry while a profiler records."""

    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name, self.rec = name, None

    def __enter__(self):
        self.rec = REGISTRY.open(self.name)
        return self

    def __exit__(self, *exc):
        REGISTRY.close(self.rec)
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _NoSpan:
    """The shared no-op of one span name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


_NOOP: Dict[str, _NoSpan] = {}


def span(name: str):
    """The span ``name``, a context manager and a decorator: it records
    while a profiler records; otherwise it is the name's shared no-op (a
    decorator checks again at each call)."""
    if _recording():
        return _Span(name)
    noop = _NOOP.get(name)
    if noop is None:
        noop = _NOOP.setdefault(name, _NoSpan(name))
    return noop


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost open span, while a
    profiler records."""
    if _recording():
        REGISTRY.count(name, n)


def synchronize(device=None):
    """``torch.cuda.synchronize``, counted as one ``host_syncs``."""
    if _recording():
        REGISTRY.count("host_syncs")
    REGISTRY.muted = True
    try:
        torch.cuda.synchronize(device)
    finally:
        REGISTRY.muted = False


class _Mark:
    """The ``.bwd`` span of one layer call."""

    __slots__ = ("name", "first", "rec", "left", "ended")

    def __init__(self, name: str, first: int):
        self.name, self.first = name + ".bwd", first
        self.rec, self.left, self.ended = None, 0, False

    def begin(self, grad_outputs):
        if self.rec is None and not self.ended and _recording():
            self.rec = REGISTRY.open(self.name, mark=True)

    def end(self, *_):
        if not self.ended:
            self.ended = True
            if self.rec is not None:
                REGISTRY.close(self.rec)

    def done(self, grad_inputs, grad_outputs):
        self.left -= 1
        if self.left == 0:
            self.end()


def _next_sequence_nr() -> int:
    """The sequence number autograd gives the next node made on this
    thread."""
    probe = torch.empty(0, requires_grad=True).view(0)
    return probe.grad_fn._sequence_nr() + 1


def layer(name: str) -> Optional[_Mark]:
    """A mark at the start of a layer's forward while a profiler records
    and autograd is on; else None."""
    if not (_recording() and torch.is_grad_enabled()):
        return None
    return _Mark(name, _next_sequence_nr())


_SEQ_LEAF = 1 << 63      # AccumulateGrad's sequence number is 2^64 - 1


def layer_out(mark: Optional[_Mark], outputs):
    """``outputs``, unchanged.  With a mark, hooks on autograd's nodes open
    and close ``<name>.bwd`` around the backward of the nodes the layer
    made (those reachable from ``outputs`` whose sequence number is the
    mark's or later).  The span opens before the first node that takes a
    gradient from outside the layer (an output's) runs.  It closes after
    the last of the layer's exits (its nodes with an edge out of it) has
    run, since every node of the layer leads to one of them, or before
    the first node the layer feeds (one made before it) runs, whichever
    comes first: an output that takes no gradient leaves some nodes
    unrun, but the engine runs a ready node of a higher sequence number
    first, and a node gets its gradient only from nodes made after it, so
    by the time a fed node runs, every node of the layer that is to run
    has run.  Hooks add no node and leave every gradient's sum as it was,
    where an identity Function on the layer's inputs would sum the layer's
    share of a shared input's gradient apart from the rest and change its
    rounding."""
    if mark is None:
        return outputs
    starts, inside, exits, fed = [], set(), [], set()
    for t in _leaves(outputs, []):
        if t.grad_fn is not None and \
                mark.first <= t.grad_fn._sequence_nr() < _SEQ_LEAF:
            starts.append(t.grad_fn)
    todo = list(starts)
    while todo:
        node = todo.pop()
        if node in inside:
            continue
        inside.add(node)
        leaves_layer = False
        for f, _ in node.next_functions:
            if f is None:
                continue
            seq = f._sequence_nr()
            if mark.first <= seq < _SEQ_LEAF:
                todo.append(f)
            else:
                leaves_layer = True
                if seq < mark.first:
                    fed.add(f)
        if leaves_layer:
            exits.append(node)
    for node in set(starts):
        node.register_prehook(mark.begin)
    for node in fed:
        node.register_prehook(mark.end)
    mark.left = len(exits)
    for node in exits:
        node.register_hook(mark.done)
    return outputs


def _leaves(tree, out: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def reset():
    REGISTRY.reset()


def summary() -> Dict:
    return REGISTRY.summary()


def write(path: str):
    """The summary and the raw spans as JSON."""
    with open(path, "w") as f:
        json.dump({"summary": REGISTRY.summary(),
                   "spans": REGISTRY.records()}, f, indent=1)


def table(s: Dict) -> str:
    """Per span of a summary: calls, host ms, device ms and host syncs a
    step."""
    steps = max(s["steps"], 1)
    rows = [f"{'span':<26} {'calls':>7} {'host ms':>10} {'device ms':>10} "
            f"{'syncs':>7}   (a step, over {s['steps']} steps)"]
    for name, v in sorted(s["spans"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        dev = "-" if v["device_ms"] is None else \
            f"{v['device_ms'] / steps:.3f}"
        syncs = v["counters"].get("host_syncs", 0) / steps
        rows.append(f"{name:<26} {v['calls']:>7} "
                    f"{v['host_ms'] / steps:>10.3f} {dev:>10} {syncs:>7.2f}")
    return "\n".join(rows)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` region; on exit its Chrome trace goes to
    ``logdir/trace.json`` (chrome://tracing, Perfetto), spans and kernels
    on one timeline.  It records the CUDA activity too where a card is
    there.  Yields the profiler, whose ``key_averages()`` tabulates it."""
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


def parse_steps(text: str) -> tuple:
    """"A:B" -> (A, B), the first and last iteration of a window."""
    first, sep, last = text.partition(":")
    if not sep:
        raise ValueError(f"expected FIRST:LAST, got {text!r}")
    first, last = int(first), int(last)
    if not 0 < first <= last:
        raise ValueError(f"expected 0 < FIRST <= LAST, got {text!r}")
    return first, last


class StepWindow:
    """``trace(logdir)`` over the training loop's iterations ``first`` ..
    ``last``: the loop calls ``begin(it)`` before and ``end(it)`` after each
    iteration, and the caller ``close()`` when the loop is done.  On
    closing it writes ``logdir/trace.json`` and ``logdir/spans.json``
    (``write``) and prints ``table``."""

    def __init__(self, first: int, last: int, logdir: str):
        self.first, self.last, self.logdir = first, last, logdir
        self._cm = None

    def begin(self, it: int):
        if it == self.first and self._cm is None:
            reset()
            self._cm = trace(self.logdir)
            self._cm.__enter__()

    def end(self, it: int):
        if it == self.last:
            self.close()

    def close(self):
        if self._cm is None:
            return
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        cm, self._cm = self._cm, None
        cm.__exit__(None, None, None)
        write(os.path.join(self.logdir, "spans.json"))
        print(table(summary()), flush=True)
