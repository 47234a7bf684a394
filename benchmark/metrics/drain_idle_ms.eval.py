"""Device-idle milliseconds a pass inside the runner's drain: the host
intervals of the program's ``stage.runner.drain`` spans
(``adfmsl_torch/evaluation/runner.py:produce_scores``, after a pass's batches:
the scores' copies to the host and the result's assembly; read from
``adfmsl_torch.utils.profiling.recorded()``, on the profiler's clock) less the
union of the kernel intervals inside them, over the passes (one span each).
A program without the spans gives nothing to read."""
from benchlib.trace import clipped_union_us, union_us

UNIT = "ms"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    drains = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in recorded().spans
              if s.name == "stage.runner.drain"]
    if not drains or ctx.trace is None:
        return None
    idle_us = union_us(drains) - clipped_union_us(ctx.trace.kernel_intervals(), drains)
    return idle_us / 1e3 / len(drains)
