"""The share of the 3DGS step's pair slots that hold a pair the blend
reads: 100 * `bin.kept` / `bin.slots`, the binning's counters, median over
the traced steps (spans.py)."""
from benchmark.spans import slot_use


def read(ctx):
    return slot_use(ctx, "train.step")
