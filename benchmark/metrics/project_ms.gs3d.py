"""Device ms of the 3DGS step's EWA projection (`render.project`:
ops/raster3d_ref.py::prepare_splats3d, the batched 3x3 products), median
over the traced steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "render.project")
