"""The collectives of the port's multi-device paths, over ``torch.distributed``.

adfmsl's data parallelism is single-process SPMD: under GSPMD, BatchNorm
normalises over the global batch and the FMSL head's loss is the ratio of
global sums. The port runs one process per rank, so those reductions are
explicit here. Every collective is an ``all_reduce`` or a ``broadcast``: the
two that gloo also runs on CUDA tensors, so two ranks can share one card.

- ``data_parallel(group)`` names the data group of the step being run;
  ``global_sum`` reduces over it (``ops/norm.py:bn_train``'s statistics, the
  FMSL head's loss sums) and is the identity outside a data-parallel step.
  Its backward all-reduces the upstream gradient, which is right when the
  ranks' backward roots add up to the global loss (``train/steps.py``).
- ``all_reduce_flat`` sums many tensors in place through one flat buffer (the
  gradients of a data-parallel step).
- ``copy_to_model`` / ``reduce_from_model``: Megatron's conjugate pair for the
  tensor-parallel regions of the Wav2Vec2 encoder (``parallel/tp.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

_DATA_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def data_parallel(group: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Within the block, ``global_sum`` reduces over ``group`` (``None``: no
    reduction). A process-wide setting, not a thread-local one: the recompute
    of a checkpointed forward runs on autograd's thread and must see it."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = prev


def data_group() -> Optional[dist.ProcessGroup]:
    return _DATA_GROUP


class _SumAllReduce(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the sum of the upstream
    gradients over the group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, through one flat buffer per
    dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the current data group (``x`` itself outside one)."""
    group = _DATA_GROUP
    return x if group is None else _SumAllReduce.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all_reduce backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all_reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)
