"""Device ms of the train step's autograd backward (K2 and the per-splat
chain): the step's own `mark` hook, CUDA events, median over the traced
steps."""


def read(ctx):
    return ctx.stage_ms.get("backward")
