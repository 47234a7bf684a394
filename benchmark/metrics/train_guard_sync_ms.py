"""Host milliseconds a train step waits in the non-finite guard's host sync:
the program's ``train_step.guard_sync`` spans (``adfmsl_torch/train/steps.py``,
``bool(torch.isfinite(loss))`` inside ``train_step.update``; read from
``adfmsl_torch.utils.profiling.recorded()``), summed over the traced window
and divided by its steps. A program without the spans gives nothing to read."""
UNIT = "ms"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = [s.end_ns - s.start_ns for s in recorded().spans
             if s.name == "train_step.guard_sync"]
    return sum(spans) / 1e6 / ctx.calls if spans and ctx.calls else None
