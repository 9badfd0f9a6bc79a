"""Device ms of the EnvGS step's projection of the base surfels
(`render.project`: ops/common.py::prepare_splats), median over the traced
steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "render.project")
