"""Device milliseconds a forward spends in the SE-residual trunk (models/blocks.py): the union of the kernel
intervals inside the device-side spans of the ``stage.trunk`` range,
over the traced window's forwards."""
from benchlib.trace import clipped_union_us

UNIT = "ms"
STAGES = {"trunk": "trunk"}          # range label: the module it wraps


def read(ctx):
    spans = ctx.trace.device_spans.get("stage.trunk") if ctx.trace else None
    if not spans or not ctx.calls:
        return None
    return clipped_union_us(ctx.trace.kernel_intervals(), spans) / 1e3 / ctx.calls
