"""Device ms of the train step's forward with its losses: the step's own
`mark` hook, CUDA events, median over the traced steps."""


def read(ctx):
    return ctx.stage_ms.get("forward")
