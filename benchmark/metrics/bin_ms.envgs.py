"""Device ms of the EnvGS step's binning of the base pass (`render.bin`:
ops/binning.py::bin_splats, K5 among it), median over the traced steps
(spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "render.bin")
