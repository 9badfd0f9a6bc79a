"""Section timers, profiler bracketing and the program's spans (port of
envgs_tpu/utils/timer.py, plus the spans).

`Timer` records named host-side spans between `record()` calls. Device work
is asynchronous: with `sync=True` every `record` first waits for the card
(`torch.cuda.synchronize`), so a span includes the device time queued
inside it. `ProfilerSession` brackets a window of iterations with
`torch.profiler` and writes a Chrome trace.

`span(name)` and `count(name, value)` mark the layers of a render or a
train step. They do nothing but one check unless a torch profiler is
recording on this thread (the check `torch.autograd._profiler_enabled`,
the profiler state `record_function` reports to): no allocation, no CUDA
call, no aten op. Under a profiler a span enters
`torch.profiler.record_function(name)`, so it is a user annotation on the
profiler's timeline and clock, records the host's `perf_counter_ns` at
entry and exit and, once CUDA is initialised, a CUDA event pair on the
current stream; a span opened with no span open on its thread is a root,
and every span of a root (one step or one frame) shares its id. `count`
attaches a value to the innermost open span, a tensor by reference (read
only when the record is read, so a counter adds no op; it keeps the
tensor's storage alive while its root is in the record). `RECORD` holds
the last `RECORD.maxlen` roots; `read_spans` reads it without emptying
it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch


class Timer:
    """Named host-side spans: `timer.record('data')` closes the span opened
    by the previous record/tick. Records rolling means per name."""

    def __init__(self, enabled: bool = True, sync: bool = False,
                 window: int = 100):
        self.enabled = enabled
        self.sync = sync
        self.window = window
        self.spans: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._last = time.perf_counter()

    def tick(self):
        """Open a new span without recording (start of an iteration)."""
        self._last = time.perf_counter()

    def record(self, name: str) -> float:
        """Close the current span under `name`; with sync on, wait for the
        card first so queued device work is charged to this span."""
        if not self.enabled:
            return 0.0
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self._last
        self.spans[name].append(dt)
        self._last = now
        return dt

    def mean(self, name: str) -> float:
        s = self.spans.get(name)
        return float(np.mean(s)) if s else 0.0

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self.spans}

    def dump(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({k: list(map(float, v)) for k, v in self.spans.items()},
                      f)


class ProfilerSession:
    """torch.profiler trace over iterations [start, start + steps): call
    `step(it)` once per iteration and `close()` at the end; the trace goes
    to `<trace_dir>/trace.json` (Chrome trace format)."""

    def __init__(self, trace_dir: str | None = None, start: int = 10,
                 steps: int = 5):
        self.trace_dir = trace_dir
        self.start, self.steps = start, steps
        self._prof = None

    def step(self, it: int):
        if not self.trace_dir:
            return
        if it == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and it >= self.start + self.steps:
            self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir,
                                                  "trace.json"))


# ---- the program's spans and counters ----

RECORD: collections.deque = collections.deque(maxlen=64)
_recording = torch.autograd._profiler_enabled
_ids = itertools.count()
_open = threading.local()  # .stack: the spans open on this thread
_OFF = contextlib.nullcontext()  # every span while no profiler records


class _Span:
    """One span of the record: its name, parent span, root id, the list of
    its root's spans, its counters, host ns and CUDA events."""

    __slots__ = ("name", "parent", "root", "spans", "counts", "t0", "t1",
                 "ev0", "ev1", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.counts = []
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.parent is None:
            self.root, self.spans = next(_ids), [self]
            RECORD.append(self.spans)
        else:
            self.root, self.spans = self.parent.root, self.parent.spans
            self.spans.append(self)
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev1 is not None:
            self.ev1.record()
        self._rf.__exit__(*exc)
        _open.stack.pop()
        return False


def span(name: str):
    """A context manager over one layer's work, named `name`: one check
    when no profiler records, else a span of the record (module
    docstring)."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, value, at: int | None = None):
    """Attach `value` (a number, or a tensor kept by reference; with `at`,
    its element `at`, taken when the record is read) to the innermost open
    span under `name`. One check when no profiler records."""
    if not _recording():
        return
    stack = _open.__dict__.get("stack")
    if stack:
        stack[-1].counts.append((name, value, at))


def _number(value, at):
    if at is not None:
        value = value[at]
    return value.item() if isinstance(value, torch.Tensor) else value


def read_spans() -> list:
    """[{"root", "name", "host_ms", "device_ms", "counts"}] for each root of
    RECORD, oldest first: the root's id and span name, each span name's
    summed host ms and device ms (the latter only where CUDA events were
    recorded) and each counter's summed value, over the root's closed
    spans. Waits for the card once, then resolves events and tensors."""
    roots = [list(spans) for spans in RECORD]
    if any(s.ev0 is not None for spans in roots for s in spans):
        torch.cuda.synchronize()
    out = []
    for spans in roots:
        host, dev, counts = {}, {}, {}
        for s in spans:
            if s.t1 is None:
                continue
            host[s.name] = host.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-6
            if s.ev0 is not None:
                dev[s.name] = dev.get(s.name, 0.0) + s.ev0.elapsed_time(s.ev1)
            for name, value, at in s.counts:
                counts[name] = counts.get(name, 0) + _number(value, at)
        out.append({"root": spans[0].root, "name": spans[0].name,
                    "host_ms": host, "device_ms": dev, "counts": counts})
    return out
