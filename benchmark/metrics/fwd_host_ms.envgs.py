"""Host ms of the EnvGS step's forward with its losses: the host's time
inside the program's `train.forward` span, enqueuing the forward (under
the profiler), median over the traced steps (spans.py)."""
from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.step", "train.forward")
