"""The (data, model) mesh over ``torch.distributed`` ranks (port of
``adfmsl/parallel/mesh.py``).

adfmsl lays its devices out as a (dp, mp) array, data axis first. Here rank
``r`` sits at (``r // mp``, ``r % mp``): the ranks of one column (the same
model index) form a data group, over which gradients, BatchNorm statistics
and loss sums are reduced; the ranks of one row form a model group, over
which the tensor-parallel Wav2Vec2 layers reduce (``parallel/tp.py``).

A batch is sharded as GSPMD shards dim 0: data rank ``d`` of ``dp`` holds the
contiguous rows [d·b/dp, (d+1)·b/dp) of the global batch (``shard_batch``),
after the batch is padded to a multiple of ``dp`` with masked rows
(``pad_batch_to_devices``). The Trainer and the runner take those blocks
from a loader that decodes only them (``data/pipeline.py``'s ``rank`` /
``world``; ``check_loader``). ``replicate`` broadcasts rank 0's parameters
and buffers, then checks that every rank holds the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adfmsl_torch.config.base import MeshConfig


def mesh_shape(cfg: Optional[MeshConfig], n: int) -> Tuple[int, int]:
    """adfmsl's (dp, mp) arithmetic (``make_mesh`` :22-32) over ``n`` ranks."""
    cfg = cfg or MeshConfig()
    mp = max(cfg.model_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    return dp, mp


@dataclass
class Mesh:
    dp: int
    mp: int
    rank: int
    data_group: Any          # the ranks of this rank's column
    model_group: Any         # the ranks of this rank's row

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp

    @property
    def world(self) -> int:
        return self.dp * self.mp


def make_mesh(cfg: Optional[MeshConfig] = None, world: Optional[int] = None) -> Mesh:
    """The mesh of ``cfg`` over the ``world`` ranks of the default process
    group (all of them when omitted). Every rank must call it: each creates
    every group, in the same order."""
    if world is not None:
        dp, mp = mesh_shape(cfg, world)       # adfmsl's error comes first
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(adfmsl_torch.parallel.launch)")
    n = dist.get_world_size()
    dp, mp = mesh_shape(cfg, n if world is None else world)
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} over a world of {n} ranks")
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = g
    return Mesh(dp, mp, rank, data_group, model_group)


def pad_batch_to_devices(audio: np.ndarray, label: np.ndarray, mask: np.ndarray,
                         n_devices: int):
    """Round the batch up to a multiple of the data-axis size (padding rows
    carry mask=False so metrics and scores ignore them)."""
    b = audio.shape[0]
    rem = (-b) % n_devices
    if rem == 0:
        return audio, label, mask
    pad = [(0, rem)] + [(0, 0)] * (audio.ndim - 1)
    return (np.pad(audio, pad), np.pad(label, [(0, rem)]), np.pad(mask, [(0, rem)]))


def row_block(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` (a multiple of ``dp``) that this
    rank holds."""
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} rows does not tile {mesh.dp} data ranks")
    b = n // mesh.dp
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(mesh: Mesh, arrays: Sequence) -> List:
    """This rank's contiguous row block of each array (dim 0)."""
    return [a[row_block(mesh, a.shape[0])] for a in arrays]


def check_loader(mesh: Mesh, loader) -> None:
    """Raise unless ``loader`` yields this data rank's row blocks
    (``DataLoader(rank=mesh.data_rank, world=mesh.dp)``): under a mesh each
    rank decodes only its own rows, and no path cuts a global batch."""
    got = (getattr(loader, "rank", None), getattr(loader, "world", None))
    if got != (mesh.data_rank, mesh.dp):
        raise ValueError(f"under a mesh of {mesh.dp} data ranks, data rank "
                         f"{mesh.data_rank} needs a loader of its row blocks "
                         f"(rank={mesh.data_rank}, world={mesh.dp}); got rank / world {got}")


def _state_tensors(model: torch.nn.Module) -> List[torch.Tensor]:
    return list(model.parameters()) + list(model.buffers())


def replicate(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, then check
    that the ranks hold equal ones; returns ``model``."""
    with torch.no_grad():
        for t in _state_tensors(model):
            dist.broadcast(t.data, src=0)
    check_replicated(model)
    return model


def check_replicated(model: torch.nn.Module) -> None:
    """Raise unless every rank holds bitwise-equal floating parameters and
    buffers: the element-wise maximum and minimum over the ranks must agree."""
    ts = [t for t in _state_tensors(model) if t.is_floating_point()]
    if not ts:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().float().reshape(-1) for t in ts])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            n = int((hi != lo).sum())
            raise RuntimeError(f"the ranks hold different parameters ({n} elements differ)")


def broadcast_floats(values: Sequence[float], device: torch.device) -> List[float]:
    """Rank 0's ``values`` on every rank (decisions every rank must take
    alike: the plateau scale, early stopping)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return [float(v) for v in t.cpu()]
