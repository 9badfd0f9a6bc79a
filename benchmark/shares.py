"""The shares the per-layer readers take from a traced run (None where
the trace or the walks hold nothing to read):
- a blend kernel's share of its roofline: the least time the card could
  take on the work the reference's plain forward walked on the cell's
  inputs (counts.py), over the kernel's mean device time per launch in
  the traced sub-window;
- the device's idle share of the sub-window: 1 - the union of its kernels,
  copies and fills over the window's host wall time;
- the whole step's share of the card's float32 peak: the benchmark's count
  of its operations (counts.py, from the reference's walks) times the
  traced iterations, over the window's time.
All in %."""
from __future__ import annotations


def roofline(ctx, kernel: str, args: tuple, walk_of, cost) -> float | None:
    times = ctx.trace.kernel_s(kernel, args)
    walks = [w for w in ctx.walks if walk_of(w)]
    if not times or not walks:
        return None
    bound = sum(ctx.counts.bound_s(*cost(w)) for w in walks) / len(walks)
    return 100.0 * bound / (sum(times) / len(times))


def idle(ctx) -> float | None:
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx) -> float | None:
    if ctx.ops_per_iteration is None or ctx.trace.window_s <= 0:
        return None
    rate = ctx.ops_per_iteration * ctx.trace.iterations / ctx.trace.window_s
    return 100.0 * rate / ctx.counts.PEAK_F32_FLOPS
