"""Tensor parallelism (Megatron style) of the Wav2Vec2 encoder (port of
``adfmsl/parallel/tp.py``).

adfmsl's rules (:22-38) split, over the mesh's model axis, inside the
``wav2vec2`` encoder only:

- the attention's query / key / value kernels and biases on the heads
  (column-parallel);
- the attention's ``out`` kernel on the heads (row-parallel), its bias whole;
- ``intermediate_dense`` on its output width (column-parallel), and
  ``output_dense`` on its input width (row-parallel), its bias whole;
- WavLM's per-head leaves with the heads: layer 0's bucket table
  ``rel_attn_embed`` on its columns and each layer's ``gru_rel_pos_const``
  (dim 1), so each rank builds the bias of its own heads; the gate's
  ``gru_rel_pos_linear``, shared by the heads, stays whole and each rank
  applies it to its heads' slice of the layer's input (``head0``);
- everything else replicated.

In the port's (out, in) ``nn.Linear`` layout a column-parallel weight splits
on dim 0 and a row-parallel one on dim 1 (``w2v2_param_specs``).
``shard_params_tp`` keeps this rank's part of each split parameter (marked
``tp_dim``) and gives the layers their model group; their forward
(``models/w2v2.py``) enters each split region through Megatron's f (identity
forward, ``all_reduce`` backward) and leaves it through g (``all_reduce``
forward, identity backward), with the row-parallel bias added once after the
reduction. Weights come across whole (``models/port.py:state_dict_from_flax``)
and are split after loading; ``gather_params_tp`` puts them back together.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist

from adfmsl_torch.parallel.mesh import Mesh

_SPLIT = re.compile(r"^wav2vec2\.layers_\d+\.(attention\.(query|key|value|out)|"
                    r"intermediate_dense|output_dense)\.(weight|bias)$")
_ROW_PARALLEL = ("attention.out", "output_dense")
_HEAD_COLUMNS = re.compile(r"^wav2vec2\.layers_\d+\.attention\."
                           r"(rel_attn_embed\.weight|gru_rel_pos_const)$")


def param_spec(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over the model axis (``None``:
    replicated)."""
    if _HEAD_COLUMNS.match(name):
        return 1
    m = _SPLIT.match(name)
    if m is None:
        return None
    row = m.group(1) in _ROW_PARALLEL
    if m.group(3) == "bias":
        return None if row else 0
    return 1 if row else 0


def w2v2_param_specs(model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """Parameter name -> its split dim, or ``None`` where it replicates."""
    return {n: param_spec(n) for n, _ in model.named_parameters()}


def _tp_layers(model: torch.nn.Module):
    from adfmsl_torch.models.w2v2 import SelfAttention, _EncoderLayer

    for name, mod in model.named_modules():
        if name.startswith("wav2vec2.") and isinstance(mod, (SelfAttention, _EncoderLayer)):
            yield mod


def shard_params_tp(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's part of every split parameter of ``model`` (whole
    weights in) and switch its encoder layers to the tensor-parallel forward
    over ``mesh``'s model group; returns ``model``."""
    mp, r = mesh.mp, mesh.model_rank
    for mod in _tp_layers(model):
        if hasattr(mod, "heads"):
            if mod.heads % mp:
                raise ValueError(f"{mod.heads} heads do not split over {mp} ranks")
            mod.heads //= mp
            mod.head0 = r * mod.heads
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = param_spec(name)
            if dim is None:
                continue
            if p.shape[dim] % mp:
                raise ValueError(f"{name} {tuple(p.shape)} does not split over {mp} ranks")
            p.data = p.data.chunk(mp, dim=dim)[r].clone()
            p.tp_dim = dim
    for mod in _tp_layers(model):
        mod.tp_group = mesh.model_group
    return model


def gather_params_tp(model: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict of a tensor-parallel ``model``: each split
    parameter's parts meet in an ``all_reduce`` of a zero-filled whole
    tensor over the model group."""
    out = {}
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        dim = getattr(params.get(name), "tp_dim", None)
        if dim is None:
            out[name] = t.detach().clone()
            continue
        shape = list(t.shape)
        shape[dim] *= mesh.mp
        whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
        n = t.shape[dim]
        whole.narrow(dim, mesh.model_rank * n, n).copy_(t)
        dist.all_reduce(whole, group=mesh.model_group)
        out[name] = whole
    return out
