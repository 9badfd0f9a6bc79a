"""Host ms of the EnvGS step's backward: the host's time inside the
program's `train.backward` span, autograd's dispatch (under the
profiler), median over the traced steps (spans.py)."""
from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.step", "train.backward")
