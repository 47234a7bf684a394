"""Host milliseconds a train step waited on the loader: the Trainer's own
``StepTimer`` total of its ``input`` phase over the window, a step."""
UNIT = "ms"


def read(ctx):
    t = ctx.timer
    return 1e3 * t["input_s"] / ctx.calls if t and ctx.calls else None
