"""Calls a train step makes that block the host on the card's queue: the
program's ``host_syncs`` counter (``adfmsl_torch/utils/profiling.py:
count_sync``; the guard, the ``skipped`` flag's copy, the label's and mask's
copies, the Trainer's logging reads and its end-of-epoch reductions) as
recorded in the traced window, over its steps. A program without the
counter gives nothing to read."""
UNIT = "syncs"


def read(ctx):
    try:
        from adfmsl_torch.utils.profiling import recorded
    except ImportError:
        return None
    syncs = recorded().counts.get("host_syncs")
    return syncs / ctx.calls if syncs is not None and ctx.calls else None
