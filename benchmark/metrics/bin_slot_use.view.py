"""The share of a viewed frame's pair slots that hold a pair the blend
reads: 100 * `bin.kept` / `bin.slots`, median over the traced frames
(spans.py)."""
from benchmark.spans import slot_use


def read(ctx):
    return slot_use(ctx, "render")
