"""Device ms of the 3DGS step's binning (`render.bin`: ops/binning.py::
bin_splats, the sorts, the cummax over every pair slot, the gathers, the
searchsorted and K5), median over the traced steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "render.bin")
