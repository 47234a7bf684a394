"""Device milliseconds a forward spends in the model's head
(``adfmsl_torch/models/mazes.py:MazeModel.forward``, the trunk's output to the
scores: the transformer, pooling, fc1, the FMSL head, fc2): the union of the
kernel intervals inside the device-side spans of the program's
``stage.model.head`` span and of every range entered inside it. The profiler
gives a kernel to the innermost range open at its launch, so the span's own
device-side spans hold only the kernels no inner range took: the inner ranges
are the benchmark's hooks (``HOOKS``) and the program's spans recorded with
this span as their parent (``stage.k1.weights`` in the trunk). Over the traced
window's forwards. A program without the span (no recorded
``stage.model.head``) gives nothing to read."""
from benchlib.trace import clipped_union_us

UNIT = "ms"
SPAN = "stage.model.head"
HOOKS = ()                        # the benchmark enters no range in the head


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded().spans
    if ctx.trace is None or not ctx.calls or not any(s.name == SPAN for s in spans):
        return None
    inner = {SPAN, *HOOKS}
    while True:
        more = {s.name for s in spans if s.parent in inner} - inner
        if not more:
            break
        inner |= more
    pieces = [iv for name in inner for iv in ctx.trace.device_spans.get(name, [])]
    return clipped_union_us(ctx.trace.kernel_intervals(), pieces) / 1e3 / ctx.calls
