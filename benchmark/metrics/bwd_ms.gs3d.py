"""Device ms of the 3DGS step's backward (`torch.autograd.grad` and the
zero fill): the program's `train.backward` span, CUDA events, median over
the traced steps (spans.py)."""
from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.step", "train.backward")
