"""Device milliseconds a forward spends on K1's per-call work on weights
(``adfmsl_torch/models/blocks.py:_fused_eval_body``'s BN folding and
``adfmsl_torch/ops/resblock_fused.py:_launch``'s weight layout and casts,
which do not depend on the batch): the union of the kernel intervals inside the device-side
spans of the program's ``stage.k1.weights`` span, over the traced window's
forwards. A program without the span gives nothing to read."""
from benchlib.trace import clipped_union_us

UNIT = "ms"


def read(ctx):
    spans = ctx.trace.device_spans.get("stage.k1.weights") if ctx.trace else None
    if not spans or not ctx.calls:
        return None
    return clipped_union_us(ctx.trace.kernel_intervals(), spans) / 1e3 / ctx.calls
