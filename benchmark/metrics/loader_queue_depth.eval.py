"""Batches the runner found waiting in the loader's prefetch queue at a get:
the program's ``loader.ready`` counter (``q.qsize()`` summed over the gets,
``adfmsl_torch/data/pipeline.py:DataLoader.__iter__``) over its
``loader.gets``, as recorded in the traced window
(``adfmsl_torch.utils.profiling.recorded()``). A program without the
counters gives nothing to read."""
UNIT = "batches"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    counts = recorded().counts
    gets = counts.get("loader.gets", 0)
    return counts.get("loader.ready", 0) / gets if gets else None
