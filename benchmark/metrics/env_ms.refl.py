"""Device ms of the EnvGS step's env pass: the program's `render.env` span
(the env set's colours and table, the reflected rays' tiles, the cull, K3;
K4 runs in the backward), CUDA events, median over the traced steps
(spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "render.env")
