"""The share of the traced window in which no operation ran on the device:
1 - the union of all device intervals over the window."""
UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / (ctx.window_s * 1e6))
