"""Weights across the two packages, and the port's checkpoint files
(``model.pt``, also one per epoch in a training checkpoint directory).

``state_dict_from_flax`` turns adfmsl's flax trees (as nested dicts of numpy
arrays) into a state dict that the port's ``MazeModel`` accepts with
``load_state_dict(strict=True)``. Module names follow the flax tree:
``sinc``, ``first_bn``, ``trunk.block{i}.{bn1,conv1,bn2,conv2,downsample,se}``,
``fc1``, ``fc2``, ``fmsl.{proj,proj_bn,prototypes,weight,temperature}``, for
the Wav2Vec2 models ``wav2vec2.*`` (``models/w2v2.py``), ``proj``,
``conv_fmsl.{freq_mod_conv,freq_mod_bn,spec_enh_conv,spec_enh_bn,att1,att2,
out_proj}``, ``bn_before_transformer``, ``transformer.{in_proj,pos_embedding,
out_proj}`` and ``transformer.layer{i}.{self_attn.{query,key,value,out},norm1,
ff1,ff2,norm2}``, ``asp.{att1,att2}``, and
for RawNet ``encoder.{sinc,first_bn,block{i},fc_attention{i},bn_before_gru,
fc1_gru}`` with the GRU's gates ``encoder.gru.cell.{ir,iz,in,hr,hz,hn}``
(a stacked GRU's later layers ``cell1``, ``cell2``, ..., as in adfmsl's tree).

The LFCC / log-mel models (``models/lcnn.py``, ``models/resnet.py``) keep
their flax names too (``conv1``, ``nin1``, ``bn1``, ..., ``b1_conv``, ``b1_bn``,
..., ``stem``, ``stem_bn``, ``layer{i}_{j}.{conv1,bn1,conv2,bn2,proj,proj_bn}``,
``fc1``, ``fc2``, ``fc``).

Layouts: a flax conv kernel (K, Cin, Cout) becomes a torch weight (Cout, Cin, K),
a 2-D one (kh, kw, Cin, Cout) a weight (Cout, Cin, kh, kw);
a Dense kernel (in, out), a GRU gate's included, a Linear weight (out, in)
(adfmsl's GRU keeps flax ``GRUCell``'s gates, so nothing is regrouped as for
``nn.GRU``); BatchNorm scale/bias and
batch_stats mean/var become weight/bias/running_mean/running_var, with
num_batches_tracked 0; a LayerNorm's or GroupNorm's scale/bias become
weight/bias; flax attention's DenseGeneral kernels (H, heads, hd) and
(heads, hd, H) (the encoder's ``attention``, the transformer's ``self_attn``)
are flattened to Linear weights (H, H); a bare parameter (the positional
embedding) keeps its shape.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from adfmsl_torch.config.base import ExperimentConfig, experiment_from_dict

CHECKPOINT_FILE = "model.pt"


def _walk(params: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
          out: "OrderedDict[str, torch.Tensor]") -> int:
    """Convert one level of the tree; returns the number of leaves consumed
    (params and batch_stats together)."""
    n = 0
    for name, node in params.items():
        key = f"{prefix}{name}"
        sub_stats = stats.get(name, {}) if stats else {}
        if not isinstance(node, Mapping):                  # a bare parameter
            out[key] = torch.from_numpy(np.array(node, dtype=np.float32))
            n += 1
        elif "kernel" in node:                             # conv or Dense
            k = np.asarray(node["kernel"], dtype=np.float32)
            # (..., Cin, Cout) -> (Cout, Cin, ...): the spatial axes keep their order
            w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
            out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
            n += 1
            if "bias" in node:
                out[f"{key}.bias"] = torch.from_numpy(
                    np.array(node["bias"], dtype=np.float32))
                n += 1
        elif "scale" in node:                     # BatchNorm, or Layer/GroupNorm
            out[f"{key}.weight"] = torch.from_numpy(np.array(node["scale"], np.float32))
            out[f"{key}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
            n += 2
            if "mean" in sub_stats:
                out[f"{key}.running_mean"] = torch.from_numpy(
                    np.array(sub_stats["mean"], np.float32))
                out[f"{key}.running_var"] = torch.from_numpy(
                    np.array(sub_stats["var"], np.float32))
                out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
                n += 2
        else:
            n += _walk(node, sub_stats, f"{key}.", out)
    return n


def _count(tree: Mapping[str, Any]) -> int:
    return sum(_count(v) if isinstance(v, Mapping) else 1 for v in tree.values())


def _flat_attention(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """flax ``MultiHeadDotProductAttention``'s DenseGeneral projections as
    plain Dense ones: query / key / value kernels (H, heads, hd) -> (H, H)
    with biases (heads, hd) -> (H,), the out kernel (heads, hd, H) -> (H, H)."""
    out = {}
    for name, node in tree.items():
        if not isinstance(node, Mapping):
            out[name] = node
        elif name in ("attention", "self_attn") and "query" in node:
            flat = {}
            for proj, d in node.items():
                k = np.asarray(d["kernel"])
                k = k.reshape(-1, k.shape[-1]) if proj == "out" else k.reshape(k.shape[0], -1)
                flat[proj] = {"kernel": k, "bias": np.reshape(d["bias"], (-1,))}
            out[name] = flat
        else:
            out[name] = _flat_attention(node)
    return out


def flax_tree_to_state_dict(params: Mapping[str, Any],
                            batch_stats: Optional[Mapping[str, Any]] = None
                            ) -> "OrderedDict[str, torch.Tensor]":
    """A flax variable tree (nested dicts of numpy arrays) -> the state dict
    of the port's module of the same names. Raises if a leaf was not used."""
    params = _flat_attention(params)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    used = _walk(params, batch_stats or {}, "", out)
    total = _count(params) + _count(batch_stats or {})
    if used != total:
        raise ValueError(f"converted {used} of {total} flax leaves")
    return out


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         model_name: str) -> "OrderedDict[str, torch.Tensor]":
    """adfmsl ``MazeModel`` variables of ``model_name`` -> the port's state dict.
    Raises if the model is not ported or a leaf of either tree was not used."""
    from adfmsl_torch.models.mazes import model_registry

    if model_name not in model_registry:
        raise KeyError(f"model {model_name!r} is not ported; ported: "
                       f"{model_registry.names()}")
    try:
        return flax_tree_to_state_dict(params, batch_stats)
    except ValueError as e:
        raise ValueError(f"{model_name}: {e}") from None


def save_checkpoint(path: str, exp: ExperimentConfig, model: torch.nn.Module) -> str:
    """Write ``path/model.pt``: the experiment config (a plain dict) and the
    model's state dict. Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    f = os.path.join(path, CHECKPOINT_FILE)
    torch.save({"config": dataclasses.asdict(exp),
                "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               f)
    return f


def epoch_dir(path: str, epoch: int) -> str:
    """Where a training checkpoint directory keeps epoch ``epoch``."""
    return os.path.join(path, f"epoch_{epoch}")


def epoch_dirs(path: str) -> List[Tuple[int, str]]:
    """The ``epoch_<e>`` directories of a training checkpoint directory
    (``train/checkpoint.py``), as (epoch, path) in epoch order."""
    out = []
    for name in os.listdir(path) if os.path.isdir(path) else ():
        head, _, tail = name.partition("_")
        if head == "epoch" and tail.isdigit():
            out.append((int(tail), os.path.join(path, name)))
    return sorted(out)


def load_checkpoint(path: str, map_location: Optional[Union[str, torch.device]] = "cpu"
                    ) -> Tuple[ExperimentConfig, "OrderedDict[str, torch.Tensor]"]:
    """Read ``path/model.pt`` -> (experiment config, state dict); for a
    training checkpoint directory, the latest epoch's ``model.pt``. Loads with
    ``weights_only=True``: the file holds tensors and plain containers only."""
    f = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.exists(f) and epoch_dirs(path):
        f = os.path.join(epoch_dirs(path)[-1][1], CHECKPOINT_FILE)
    obj = torch.load(f, map_location=map_location, weights_only=True)
    return experiment_from_dict(obj["config"]), obj["state_dict"]
