"""Device ms of the 3DGS step's forward with its losses: the program's
`train.forward` span (models/gaussiant.py), CUDA events, median over the
traced steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "train.forward")
