"""Host milliseconds a train step spends moving its batch to the device: the
program's ``train_step.place`` spans (``adfmsl_torch/train/loop.py:
Trainer._place``, the audio's copy and the label's and mask's blocking
copies; read from ``adfmsl_torch.utils.profiling.recorded()``), summed over
the traced window and divided by its steps. A program without the spans
gives nothing to read."""
UNIT = "ms"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = [s.end_ns - s.start_ns for s in recorded().spans if s.name == "train_step.place"]
    return sum(spans) / 1e6 / ctx.calls if spans and ctx.calls else None
