"""Device milliseconds a forward spends in WavLM's attention
(``adfmsl_torch/models/w2v2.py``): the union of the kernel intervals inside
the device-side spans of the program's ``stage.w2v2.attention`` spans (each
layer's scores to its weighted sum, the gate and ``g * bias`` included), of
``stage.w2v2.relpos`` (the bias table, once a forward) and of every span
recorded inside them (``stage.w2v2.gate``). The profiler gives a kernel to the
innermost range open at its launch, so the spans are read by parent, as
``model_head_ms.eval`` reads its own. Over the traced window's forwards. A
program without the spans (no relative-position bias, or none recorded) gives
nothing to read."""
from benchlib.trace import clipped_union_us

UNIT = "ms"
SPANS = ("stage.w2v2.attention", "stage.w2v2.relpos")


def device_ms(ctx, names):
    """Device ms a forward inside the spans ``names`` and every span recorded
    inside them; ``None`` where the program recorded none of ``names``."""
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded().spans
    if ctx.trace is None or not ctx.calls or not any(s.name in names for s in spans):
        return None
    inner = set(names)
    while True:
        more = {s.name for s in spans if s.parent in inner} - inner
        if not more:
            break
        inner |= more
    pieces = [iv for name in inner for iv in ctx.trace.device_spans.get(name, [])]
    return clipped_union_us(ctx.trace.kernel_intervals(), pieces) / 1e3 / ctx.calls


def read(ctx):
    return device_ms(ctx, SPANS)
