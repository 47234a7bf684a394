"""Device milliseconds a forward spends in the Wav2Vec2 encoder (models/w2v2.py): the union of the kernel
intervals inside the device-side spans of the ``stage.w2v2_encoder`` range,
over the traced window's forwards."""
from benchlib.trace import clipped_union_us

UNIT = "ms"
STAGES = {"w2v2_encoder": "wav2vec2"}          # range label: the module it wraps


def read(ctx):
    spans = ctx.trace.device_spans.get("stage.w2v2_encoder") if ctx.trace else None
    if not spans or not ctx.calls:
        return None
    return clipped_union_us(ctx.trace.kernel_intervals(), spans) / 1e3 / ctx.calls
