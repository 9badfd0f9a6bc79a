"""A short profiled sub-window of a cell and what the per-layer metrics
read from it: `torch.profiler` over a few iterations (CPU and CUDA
activities), its timeline exported as a Chrome trace into TMPDIR, read
back and deleted.

- window_s: the host's wall time of the profiled iterations, which end in
  a synchronize, so every device operation they enqueued lies within it;
- busy_s: the union of the device's kernels, copies and fills inside it;
- kernel times by name, the names parsed into the kernel's base name and
  its template arguments (`raster_blend_bwd_kernel`, ("0",));
- the breakdown: the device operations that took most time and the
  longest idle gaps, each named by the innermost host operation running
  at the gap's middle.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_WINDOW = "bench.window"


def parse_kernel(name: str) -> tuple[str, tuple]:
    """("void (anonymous namespace)::k<0, (bool)1>(float const*, int)") ->
    ("k", ("0", "true")): the base name without its namespace and the
    template arguments, with (bool) and (int) casts written plainly."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    if "<" not in name.split("(", 1)[0]:
        return name.split("(", 1)[0].strip().rsplit("::", 1)[-1], ()
    base, rest = name.split("<", 1)
    base = base.rsplit("::", 1)[-1]
    depth, args, cur = 1, [], ""
    for ch in rest:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                break
        if ch == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    args.append(cur.strip())
    norm = {"(bool)0": "false", "(bool)1": "true"}
    return base.strip(), tuple(norm.get(a, re.sub(r"^\(int\)", "", a))
                               for a in args)


class Trace:
    """The device timeline of one profiled sub-window of `iterations`."""

    def __init__(self, events: list, window_s: float, iterations: int):
        self.window_s = window_s
        self.iterations = iterations
        ann = [e for e in events if e.get("name") == _WINDOW
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        t0 = min(e["ts"] for e in ann) if ann else None
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                      e["name"]) for e in events
                     if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X")
        if t0 is None:
            t0 = dev[0][0] if dev else 0.0
        t1 = t0 + window_s * 1e6
        self.device = [(max(a, t0), min(b, t1), n) for a, b, n in dev
                       if b > t0 and a < t1]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                      e["name"]) for e in events
                     if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
        merged = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def kernel_s(self, base: str, args: tuple | None = None) -> list:
        """Durations (s) of the kernels named `base` (with exactly the
        template arguments `args`, when given)."""
        out = []
        for a, b, n in self.device:
            kb, ka = parse_kernel(n)
            if kb == base and (args is None or ka == tuple(args)):
                out.append((b - a) * 1e-6)
        return out

    def _host_at(self, t: float) -> str:
        inner = [(b - a, n) for a, b, n in self.host if a <= t <= b]
        return min(inner)[1] if inner else "host outside any operation"

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for a, b, n in self.device:
            key = n if len(n) <= 120 else n[:117] + "..."
            by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at(0.5 * (a + b)), (b - a) * 1e-6]
                              for a, b in gaps]}


def profile(run_one, iterations: int) -> Trace:
    """Trace `run_one(i)` for i < iterations, after a synchronize, ending
    in one."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            t0 = time.perf_counter()
            for i in range(iterations):
                run_one(i)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window_s, iterations)
