"""Device ms of a viewed frame's binning (`render.bin`), median over the
traced frames (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "render", "render.bin")
