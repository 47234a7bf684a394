"""Device milliseconds a forward spends in the SincNet filterbank conv (models/sincnet.py): the union of the kernel
intervals inside the device-side spans of the ``stage.sinc_frontend`` range,
over the traced window's forwards."""
from benchlib.trace import clipped_union_us

UNIT = "ms"
STAGES = {"sinc_frontend": "sinc"}          # range label: the module it wraps


def read(ctx):
    spans = ctx.trace.device_spans.get("stage.sinc_frontend") if ctx.trace else None
    if not spans or not ctx.calls:
        return None
    return clipped_union_us(ctx.trace.kernel_intervals(), spans) / 1e3 / ctx.calls
