"""Device ms of the env pass's cull: the program's `env.cull` span
(`ops/tracer.py::cull_and_sort`: the chunk index, the coarse cone test,
the refine, the radial sort, the slot layout), CUDA events, median over
the traced steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "env.cull")
