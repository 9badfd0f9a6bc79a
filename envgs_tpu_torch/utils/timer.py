"""Section timers and profiler bracketing (port of envgs_tpu/utils/
timer.py).

`Timer` records named host-side spans between `record()` calls. Device work
is asynchronous: with `sync=True` every `record` first waits for the card
(`torch.cuda.synchronize`), so a span includes the device time queued
inside it. `ProfilerSession` brackets a window of iterations with
`torch.profiler` and writes a Chrome trace.
"""
from __future__ import annotations

import collections
import json
import os
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
