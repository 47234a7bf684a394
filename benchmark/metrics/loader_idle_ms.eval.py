"""Device-idle milliseconds a pass while the runner waits on the loader: the
host intervals of the program's ``stage.loader.get`` spans
(``adfmsl_torch/data/pipeline.py:DataLoader.__iter__``, one a batch; read from
``adfmsl_torch.utils.profiling.recorded()``, on the profiler's clock) less the
union of the kernel intervals inside them, over the passes (the
``stage.runner.drain`` spans). A program without the spans gives nothing to
read."""
from benchlib.trace import clipped_union_us, union_us

UNIT = "ms"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded().spans
    gets = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans if s.name == "stage.loader.get"]
    passes = sum(s.name == "stage.runner.drain" for s in spans)
    if not gets or not passes or ctx.trace is None:
        return None
    idle_us = union_us(gets) - clipped_union_us(ctx.trace.kernel_intervals(), gets)
    return idle_us / 1e3 / passes
