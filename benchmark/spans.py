"""What the per-layer readers take from the program's own spans and
counters (envgs_tpu_torch/utils/timer.py: `span`, `count`, `read_spans`),
which the program records while a profiler runs, that is in the traced
sub-window of a --trace 1 run: its last `ctx.trace.iterations` roots of
the kind the cell times ("train.step" a step, "render" a frame), and of
each the sum over its spans of one name or of one counter. A reader gives
the median of those sums over the roots.

None where the program keeps no such record (a program without spans),
where the record holds no such root, or where the quantity was not
recorded: device ms come from CUDA events, so a run on the CPU has none.
"""
from __future__ import annotations

import statistics


def roots(ctx, root: str) -> list:
    """The record of the last `ctx.trace.iterations` roots named `root`."""
    try:
        from envgs_tpu_torch.utils.timer import read_spans
    except ImportError:
        return []
    found = [r for r in read_spans() if r["name"] == root]
    n = ctx.trace.iterations
    return found[-n:] if n > 0 else []


def _median(values: list) -> float | None:
    return statistics.median(values) if values else None


def device_ms(ctx, root: str, name: str) -> float | None:
    """Median device ms of the spans named `name` a root (CUDA events)."""
    return _median([r["device_ms"][name] for r in roots(ctx, root)
                    if name in r["device_ms"]])


def host_ms(ctx, root: str, name: str) -> float | None:
    """Median host ms of the spans named `name` a root: the host's time
    inside them, enqueuing their work."""
    return _median([r["host_ms"][name] for r in roots(ctx, root)
                    if name in r["host_ms"]])


def slot_use(ctx, root: str) -> float | None:
    """Median over the roots of 100 * bin.kept / bin.slots, in %: the share
    of the binning's pair slots that hold a pair the blend reads."""
    return _median([100.0 * r["counts"]["bin.kept"] / r["counts"]["bin.slots"]
                    for r in roots(ctx, root)
                    if r["counts"].get("bin.slots")
                    and "bin.kept" in r["counts"]])
