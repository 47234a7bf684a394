"""Host milliseconds the runner waited on the loader for a batch: the mean
length of the program's ``stage.loader.get`` spans
(``adfmsl_torch/data/pipeline.py:DataLoader.__iter__``, one a batch, around
the consumer's get from the prefetch queue), read from
``adfmsl_torch.utils.profiling.recorded()``. A program without the spans
gives nothing to read."""
UNIT = "ms"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    gets = [s.end_ns - s.start_ns for s in recorded().spans if s.name == "stage.loader.get"]
    return sum(gets) / 1e6 / len(gets) if gets else None
