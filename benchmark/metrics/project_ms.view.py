"""Device ms of a viewed frame's EWA projection (`render.project`), median
over the traced frames (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "render", "render.project")
