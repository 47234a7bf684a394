"""Device milliseconds a step spends under the train step's
``train_step.backward`` label (``adfmsl_torch/train/steps.py:STEP_LABELS``):
the union of the kernel intervals inside the label's device-side spans, over
the traced window's steps."""
from benchlib.trace import clipped_union_us

UNIT = "ms"


def read(ctx):
    spans = ctx.trace.device_spans.get("train_step.backward") if ctx.trace else None
    if not spans or not ctx.calls:
        return None
    return clipped_union_us(ctx.trace.kernel_intervals(), spans) / 1e3 / ctx.calls
