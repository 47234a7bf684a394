"""Weights across the two packages, the reference torch checkpoints, and the
port's checkpoint files (``model.pt``, also one per epoch in a training
checkpoint directory).

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

The thesis's torch checkpoints (``.pth``) come in through adfmsl's own route
(its ``models/port.py``, copied here): ``load_torch_state_dict`` reads one,
``port_maze_state_dict`` maps its keys onto adfmsl's flax tree for any of the
16 maze models, ``state_dict_from_flax`` turns that tree into the port's state
dict, and ``merge`` lays it over a freshly built model's. Under
``reference_parity_experiment`` the model then computes what the torch
reference does; ``python -m adfmsl_torch.cli.convert_maze`` writes the result
as a checkpoint directory.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from adfmsl_torch.config.base import ExperimentConfig, experiment_from_dict

CHECKPOINT_FILE = "model.pt"


# a norm's flax leaves -> the torch names (params, then batch_stats)
_NORM_LEAVES = (("scale", "weight"), ("bias", "bias"))
_STAT_LEAVES = (("mean", "running_mean"), ("var", "running_var"))


def _f32(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _walk(params: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
          out: "OrderedDict[str, torch.Tensor]") -> int:
    """Convert one level of the tree; returns the number of leaves consumed
    (params and batch_stats together). A partial tree (a ported reference
    checkpoint with keys missing) converts leaf by leaf."""
    n = 0
    stats = stats or {}
    for name in list(params) + [k for k in stats if k not in params]:
        node = params.get(name, {})
        key = f"{prefix}{name}"
        sub_stats = stats.get(name, {})
        if not isinstance(node, Mapping):                  # a bare parameter
            out[key] = _f32(node)
            n += 1
        elif "kernel" in node:                             # conv or Dense
            k = np.asarray(node["kernel"], dtype=np.float32)
            # (..., Cin, Cout) -> (Cout, Cin, ...): the spatial axes keep their order
            w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
            out[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
            n += 1
            if "bias" in node:
                out[f"{key}.bias"] = _f32(node["bias"])
                n += 1
        elif "scale" in node or "mean" in sub_stats or "var" in sub_stats:
            # BatchNorm, or Layer/GroupNorm
            for tree, leaves in ((node, _NORM_LEAVES), (sub_stats, _STAT_LEAVES)):
                for src, dst in leaves:
                    if src in tree:
                        out[f"{key}.{dst}"] = _f32(tree[src])
                        n += 1
            if sub_stats:
                out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:
            n += _walk(node, sub_stats, f"{key}.", out)
    return n


def _count(tree: Mapping[str, Any]) -> int:
    return sum(_count(v) if isinstance(v, Mapping) else 1 for v in tree.values())


def _flat_attention(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """flax ``MultiHeadDotProductAttention``'s DenseGeneral projections as
    plain Dense ones: query / key / value kernels (H, heads, hd) -> (H, H)
    with biases (heads, hd) -> (H,), the out kernel (heads, hd, H) -> (H, H).
    An attention's other leaves (WavLM's gate and bucket table) pass as they
    are."""
    out = {}
    for name, node in tree.items():
        if not isinstance(node, Mapping):
            out[name] = node
        elif name in ("attention", "self_attn") and "query" in node:
            flat = {}
            for proj, d in node.items():
                if proj not in ("query", "key", "value", "out"):
                    flat[proj] = d
                    continue
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


# ---------------------------------------------------------------------------------
# Reference torch checkpoints (port of adfmsl/models/port.py :38-526)
# ---------------------------------------------------------------------------------

def _t(a) -> np.ndarray:
    """torch tensor / array -> float32 numpy."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference ``.pth`` / ``.pt`` checkpoint into {key: np.ndarray}:
    a bare state dict, or a rich dict holding it under 'model_state_dict'
    (the reference's resume checkpoints, maze3.py:850-880) or 'state_dict';
    leaves that are not arrays are dropped (adfmsl :45-56). It unpickles with
    ``weights_only=False``, as adfmsl does, because the thesis's rich dicts
    carry objects besides tensors: read trusted files only."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: _t(v) for k, v in obj.items() if hasattr(v, "shape")}


class _Mapper:
    """Builds adfmsl's flax-shaped (params, batch_stats) trees of numpy arrays
    from a reference torch state dict, tracking the torch keys consumed and
    the ones expected but absent (adfmsl :59-280). Layouts: a torch Conv1d
    (out, in, k) becomes a flax kernel (k, in, out), a Linear (out, in) a
    kernel (in, out), a BatchNorm1d's weight / bias / running_mean /
    running_var flax's scale / bias and batch_stats mean / var."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = dict(sd)
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}
        self.missing: List[str] = []

    def _set(self, tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def take(self, key: str) -> Optional[np.ndarray]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        return self.sd.pop(key)

    def conv(self, tkey: str, *path: str, bias: bool = True):
        w = self.take(f"{tkey}.weight")
        if w is not None:
            self._set(self.params, path + ("kernel",), np.transpose(w, (2, 1, 0)))
        if bias:
            b = self.take(f"{tkey}.bias")
            if b is not None:
                self._set(self.params, path + ("bias",), b)

    def dense(self, tkey: str, *path: str, bias: bool = True):
        w = self.take(f"{tkey}.weight")
        if w is not None:
            self._set(self.params, path + ("kernel",), w.T)
        if bias:
            b = self.take(f"{tkey}.bias")
            if b is not None:
                self._set(self.params, path + ("bias",), b)

    def bn(self, tkey: str, *path: str):
        w, b = self.take(f"{tkey}.weight"), self.take(f"{tkey}.bias")
        m, v = self.take(f"{tkey}.running_mean"), self.take(f"{tkey}.running_var")
        self.sd.pop(f"{tkey}.num_batches_tracked", None)
        for tree, leaf, a in ((self.params, "scale", w), (self.params, "bias", b),
                              (self.stats, "mean", m), (self.stats, "var", v)):
            if a is not None:
                self._set(tree, path + (leaf,), a)

    def raw(self, tkey: str, *path: str, reshape=None):
        a = self.take(tkey)
        if a is not None:
            self._set(self.params, path, a if reshape is None else a.reshape(reshape))

    def se(self, tkey: str, *path: str):
        """Reference SEBlock: fc.0 / fc.2, bias-free (maze4.py:149-163)."""
        self.dense(f"{tkey}.fc.0", *path, "fc1", bias=False)
        self.dense(f"{tkey}.fc.2", *path, "fc2", bias=False)

    def res_block(self, tkey: str, *path: str, first: bool = False,
                  skip_key: str = "conv_downsample"):
        """Reference Residual_Block_SE (maze4.py:105-147); maze3's file-local
        variant names the 1x1 skip 'shortcut' and nests its SEBlock ('se',
        maze3.py:206-263)."""
        if not first:
            self.bn(f"{tkey}.bn1", *path, "bn1")
        self.conv(f"{tkey}.conv1", *path, "conv1")
        self.bn(f"{tkey}.bn2", *path, "bn2")
        self.conv(f"{tkey}.conv2", *path, "conv2")
        if any(k.startswith(f"{tkey}.se.") for k in self.sd):
            self.se(f"{tkey}.se", *path, "se")
        if any(k.startswith(f"{tkey}.{skip_key}.") for k in self.sd):
            self.conv(f"{tkey}.{skip_key}", *path, "downsample")

    def res_block_plain(self, tkey: str, *path: str, first: bool = False):
        """The FMSL files' block (maze3/6_fmsl_standardized.py:48-94): bias-free
        convs, a 'shortcut' skip (Identity when unused)."""
        if not first:
            self.bn(f"{tkey}.bn1", *path, "bn1")
        self.conv(f"{tkey}.conv1", *path, "conv1", bias=False)
        self.bn(f"{tkey}.bn2", *path, "bn2")
        self.conv(f"{tkey}.conv2", *path, "conv2", bias=False)
        if f"{tkey}.shortcut.weight" in self.sd:
            self.conv(f"{tkey}.shortcut", *path, "downsample", bias=False)

    def asp(self, tkey: str, *path: str):
        """AttentiveStatisticsPooling (maze6.py:167-180): attention_mlp.0 / .2."""
        self.dense(f"{tkey}.attention_mlp.0", *path, "att1")
        self.dense(f"{tkey}.attention_mlp.2", *path, "att2")

    def conv_as_dense(self, tkey: str, *path: str):
        """A k=1 Conv1d applied to (B, C, 1) or (B, C, T): a Dense."""
        w, b = self.take(f"{tkey}.weight"), self.take(f"{tkey}.bias")
        if w is not None:
            self._set(self.params, path + ("kernel",), w[:, :, 0].T)
        if b is not None:
            self._set(self.params, path + ("bias",), b)

    def asp_conv(self, tkey: str, *path: str):
        """maze6_fmsl's Conv1d-attention ASP (maze6_fmsl_standardized.py:
        189-197): attention.0 / attention.2 are Dense att1 / att2."""
        self.conv_as_dense(f"{tkey}.attention.0", *path, "att1")
        self.conv_as_dense(f"{tkey}.attention.2", *path, "att2")

    def conv_fmsl(self, tkey: str, *path: str):
        """maze8's FMSLLayer (maze8.py:76-131) -> ConvFMSLLayer."""
        self.conv(f"{tkey}.freq_modulation.0", *path, "freq_mod_conv")
        self.bn(f"{tkey}.freq_modulation.1", *path, "freq_mod_bn")
        self.conv(f"{tkey}.spectral_enhancement.0", *path, "spec_enh_conv")
        self.bn(f"{tkey}.spectral_enhancement.1", *path, "spec_enh_bn")
        for idx, name in ((1, "att1"), (3, "att2")):
            w = self.take(f"{tkey}.freq_attention.{idx}.weight")
            if w is not None:
                self._set(self.params, path + (name, "kernel"), w[:, :, 0].T)
                b = self.take(f"{tkey}.freq_attention.{idx}.bias")
                if b is not None:
                    self._set(self.params, path + (name, "bias"), b)
        self.conv(f"{tkey}.output_projection", *path, "out_proj")

    def gru(self, tkey: str, *path: str) -> int:
        """torch's stacked ``nn.GRU`` -> the GRU cells' gates ``ir``, ``iz``,
        ``in``, ``hr``, ``hz``, ``hn`` (``models/blocks.py:GRU``). torch packs
        the gates as rows [r; z; n] of weight_ih_l{k} (3H, in) and
        weight_hh_l{k} (3H, H) with two bias vectors; the cell keeps one bias
        per input gate (b_ir + b_hr and b_iz + b_hz merge exactly, since
        r = sigma(W_ir x + b_ir + W_hr h + b_hr)) and hn's own (n = tanh(W_in x
        + b_in + r * (W_hn h + b_hn)) in both). Returns the layer count."""
        k = 0
        while f"{tkey}.weight_ih_l{k}" in self.sd:
            wih = self.take(f"{tkey}.weight_ih_l{k}")
            whh = self.take(f"{tkey}.weight_hh_l{k}")
            bih = self.take(f"{tkey}.bias_ih_l{k}")
            bhh = self.take(f"{tkey}.bias_hh_l{k}")
            h = whh.shape[1]
            cell = path + ("cell" if k == 0 else f"cell{k}",)

            def g(a, i):   # gate i in torch's order r, z, n
                return a[i * h:(i + 1) * h]

            for i, gate in enumerate(("r", "z", "n")):
                self._set(self.params, cell + (f"i{gate}", "kernel"), g(wih, i).T)
                self._set(self.params, cell + (f"h{gate}", "kernel"), g(whh, i).T)
            self._set(self.params, cell + ("ir", "bias"), g(bih, 0) + g(bhh, 0))
            self._set(self.params, cell + ("iz", "bias"), g(bih, 1) + g(bhh, 1))
            self._set(self.params, cell + ("in", "bias"), g(bih, 2))
            self._set(self.params, cell + ("hn", "bias"), g(bhh, 2))
            k += 1
        if k == 0:
            self.missing.append(f"{tkey}.weight_ih_l0")
        return k

    def fmsl(self, tkey: str, *path: str):
        """Reference AdvancedFMSLSystem (fmsl_advanced.py:103-150) -> FMSLHead."""
        self.dense(f"{tkey}.projection.0", *path, "proj")
        self.bn(f"{tkey}.projection.1", *path, "proj_bn")
        self.raw(f"{tkey}.prototypes", *path, "prototypes")
        self.raw(f"{tkey}.weight", *path, "weight")
        self.raw(f"{tkey}.temperature", *path, "temperature", reshape=())

    def torch_encoder_layer(self, tkey: str, *path: str, d: int, heads: int):
        """torch ``nn.TransformerEncoderLayer`` -> TransformerEncoderLayer
        (post-LN, ReLU FFN): in_proj packs the q / k / v rows; flax's attention
        kernels are (d, heads, head_dim), the out one (heads, head_dim, d)."""
        hd = d // heads
        wqkv = self.take(f"{tkey}.self_attn.in_proj_weight")
        bqkv = self.take(f"{tkey}.self_attn.in_proj_bias")
        if wqkv is not None:
            for i, proj in enumerate(("query", "key", "value")):
                self._set(self.params, path + ("self_attn", proj, "kernel"),
                          wqkv[i * d:(i + 1) * d].T.reshape(d, heads, hd))
                if bqkv is not None:
                    self._set(self.params, path + ("self_attn", proj, "bias"),
                              bqkv[i * d:(i + 1) * d].reshape(heads, hd))
        wo = self.take(f"{tkey}.self_attn.out_proj.weight")
        if wo is not None:
            self._set(self.params, path + ("self_attn", "out", "kernel"),
                      wo.T.reshape(heads, hd, d))
            self._set(self.params, path + ("self_attn", "out", "bias"),
                      self.take(f"{tkey}.self_attn.out_proj.bias"))
        for norm in ("norm1", "norm2"):
            w, b = self.take(f"{tkey}.{norm}.weight"), self.take(f"{tkey}.{norm}.bias")
            if w is not None:
                self._set(self.params, path + (norm, "scale"), w)
                self._set(self.params, path + (norm, "bias"), b)
        self.dense(f"{tkey}.linear1", *path, "ff1")
        self.dense(f"{tkey}.linear2", *path, "ff2")

    def transformer_layers(self, tkey: str, d: int):
        i = 0
        while any(k.startswith(f"{tkey}.layers.{i}.") for k in self.sd):
            self.torch_encoder_layer(f"{tkey}.layers.{i}", "transformer", f"layer{i}",
                                     d=d, heads=8)
            i += 1

    def trunk(self, first: str, rest: Sequence[Tuple[str, str]], plain: bool = False):
        """block0 with its SE ``se0`` and the stack's later blocks with theirs
        (the SE applied after the block in the reference)."""
        block = self.res_block_plain if plain else self.res_block
        block(first, "trunk", "block0", first=True)
        self.se("se0", "trunk", "block0", "se")
        for i, (tblock, tse) in enumerate(rest, start=1):
            block(tblock, "trunk", f"block{i}")
            self.se(tse, "trunk", f"block{i}", "se")

    def w2v2_backbone(self, arch=None):
        """'wav2vec2_extractor.model.*' HF keys -> params['wav2vec2'] through
        ``models/w2v2.py:port_hf_state_dict``; the arch is inferred (base or
        large) when not given."""
        from adfmsl_torch.models.w2v2 import W2V2Arch, port_hf_state_dict

        pre = "wav2vec2_extractor.model."
        hf = {k[len(pre):]: self.sd.pop(k) for k in list(self.sd) if k.startswith(pre)}
        hf.pop("masked_spec_embed", None)        # in HF checkpoints, unused at inference
        if not hf:
            self.missing.append(pre + "*")
            return
        if arch is None:
            hidden = hf["feature_projection.projection.weight"].shape[0]
            n_layers = 1 + max(int(k.split(".")[2]) for k in hf
                               if k.startswith("encoder.layers."))
            arch = W2V2Arch.large_960h() if hidden >= 1024 else W2V2Arch.base()
            if (hidden, n_layers) not in ((768, 12), (1024, 24)):
                raise ValueError(f"cannot infer W2V2Arch for hidden={hidden}, layers="
                                 f"{n_layers}; pass w2v2_arch explicitly")
        self.params["wav2vec2"] = port_hf_state_dict(hf, arch)


_SINC_REST = [(f"res_blocks.{i}", f"se_blocks.{i}") for i in range(4)]


def port_maze_state_dict(sd: Dict[str, np.ndarray], model_name: str, w2v2_arch=None
                         ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """A reference torch state dict -> (params, batch_stats, report) in
    adfmsl's flax layout for ``model_name`` (adfmsl :283-488; all 16 maze
    models); ``state_dict_from_flax`` turns the trees into the port's state
    dict. ``report`` has 'missing' (torch keys expected but absent) and
    'unconsumed' (torch keys with no destination), the reference's
    strict=False key listing (comprehensive_evaluation.py:411-435), and for
    RawNet 'gru_layers' (build the model with ``nb_gru_layer`` = it).
    maze2_fmsl ports under fixed head semantics: its reference forward
    crashes on its own FMSL input width (maze2_fmsl_standardized.py:466-470),
    so the pooled 256-d trunk feeds the FMSL system directly."""
    m = _Mapper(sd)
    is_fmsl = model_name.endswith("_fmsl")
    base = model_name[:-5] if is_fmsl else model_name
    n_gru = None

    if base == "main":
        # RawNet2 re-driven layer by layer (main_fmsl_standardized.py:101-157);
        # main_fmsl prefixes 'backbone.'
        pre = "backbone." if any(k.startswith("backbone.") for k in m.sd) else ""
        m.raw(f"{pre}Sinc_conv.low_hz_", "encoder", "sinc", "low_hz", reshape=(-1,))
        m.raw(f"{pre}Sinc_conv.band_hz_", "encoder", "sinc", "band_hz", reshape=(-1,))
        m.sd.pop(f"{pre}Sinc_conv.n_", None)
        m.sd.pop(f"{pre}Sinc_conv.window_", None)
        m.bn(f"{pre}first_bn", "encoder", "first_bn")
        for i in range(6):
            blk = f"{pre}block{i}"
            if any(k.startswith(f"{blk}.bn1.") for k in m.sd):
                m.bn(f"{blk}.bn1", "encoder", f"block{i}", "bn1")
            m.conv(f"{blk}.conv1", "encoder", f"block{i}", "conv1")
            m.bn(f"{blk}.bn2", "encoder", f"block{i}", "bn2")
            m.conv(f"{blk}.conv2", "encoder", f"block{i}", "conv2")
            if any(k.startswith(f"{blk}.conv_downsample.") for k in m.sd):
                m.conv(f"{blk}.conv_downsample", "encoder", f"block{i}", "downsample")
            m.dense(f"{pre}fc_attention{i}", "encoder", f"fc_attention{i}")
        m.bn(f"{pre}bn_before_gru", "encoder", "bn_before_gru")
        n_gru = m.gru(f"{pre}gru", "encoder", "gru")
        m.dense(f"{pre}fc1_gru", "encoder", "fc1_gru")
        if is_fmsl:
            # Mode B (main_fmsl_standardized.py:160-174): fc1_gru's output
            # feeds the FMSL system directly
            m.fmsl("fmsl_system", "fmsl")
        else:
            # the RawNet head fc1_gru -> fc2_gru is the port's encoder + fc2
            for k in ("fc2_gru", "fc2"):
                if f"{k}.weight" in m.sd:
                    m.dense(k, "fc2")
                    break
    elif base in ("maze4", "maze5"):
        m.raw("sinc_conv.low_hz_", "sinc", "low_hz", reshape=(-1,))
        m.raw("sinc_conv.band_hz_", "sinc", "band_hz", reshape=(-1,))
        # derived constants some exports register as buffers
        m.sd.pop("sinc_conv.n_", None)
        m.sd.pop("sinc_conv.window_", None)
        m.bn("first_bn", "first_bn")
        m.trunk("block0", _SINC_REST)
        if model_name == "maze4_fmsl":
            # Mode C (maze4_fmsl_standardized.py:216-347): the pooled trunk
            # feeds the FMSL system directly
            m.fmsl("fmsl_system", "fmsl")
        else:
            m.dense("fc1", "fc1")
            m.dense("fc2", "fc2")
            if is_fmsl:   # maze5_fmsl Mode A: fc1 -> FMSL refiner -> fc2
                m.fmsl("fmsl_system", "fmsl")
    elif base in ("maze7", "maze8"):
        # maze7.py:144-217 / maze8.py:193-277 and their FMSL twins: 1x1
        # projection -> BN + SELU -> block0 + 4 strided SE blocks
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.bn("first_bn", "first_bn")
        m.trunk("block0", _SINC_REST)
        if model_name == "maze8":
            m.conv_fmsl("fmsl_layer", "conv_fmsl")
        if is_fmsl:
            m.fmsl("fmsl_system", "fmsl")
        else:
            m.dense("fc1", "fc1")
            m.dense("fc2", "fc2")
    elif model_name == "maze2":
        # maze2.py:119-193: BN over the w2v2 width, 6 SE blocks, BN + a plain
        # torch TransformerEncoder at d 256
        m.w2v2_backbone(w2v2_arch)
        m.bn("first_bn", "first_bn")
        m.trunk("block0", [(f"block{i}", f"se{i}") for i in range(1, 6)])
        m.bn("bn_before_transformer", "bn_before_transformer")
        m.transformer_layers("transformer_encoder", d=256)
        m.dense("fc1", "fc1")
        m.dense("fc2", "fc2")
    elif model_name == "maze6":
        # maze6.py:182-267: fused taps -> projection -> BN / ReLU -> block0 +
        # 4 strided blocks -> BN + a plain 4-layer transformer -> ASP -> fc1 / fc2
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.bn("first_bn", "first_bn")
        m.trunk("block0", _SINC_REST)
        m.bn("bn_before_transformer", "bn_before_transformer")
        m.transformer_layers("transformer_encoder", d=256)
        m.asp("attentive_pooling", "asp")
        m.dense("fc1", "fc1")
        m.dense("fc2", "fc2")
    elif model_name == "maze6_fmsl":
        # maze6_fmsl_standardized.py:213-382: fmsl_plain blocks, the file's
        # Conv1d-attention ASP, FMSL at 512; the fallback classifier is the
        # checkpoint's live head (the FMSL logits path KeyErrors and is
        # swallowed, :345-361), mapped to fc1 / fc2
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.bn("first_bn", "first_bn")
        m.trunk("block0", _SINC_REST[:2], plain=True)
        m.asp_conv("attentive_pooling", "asp")
        m.fmsl("fmsl_system", "fmsl")
        m.dense("classifier.0", "fc1")
        m.dense("classifier.3", "fc2")
        m.sd.pop("criterion.weight", None)
    elif model_name == "maze3_fmsl":
        # maze3_fmsl_standardized.py:139-256: fmsl_plain blocks with no SE,
        # the in-proj / pos-emb transformer (:98-137), FMSL at 256
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.res_block_plain("blocks.0", "trunk", "block0", first=True)
        m.res_block_plain("blocks.1", "trunk", "block1")
        m.res_block_plain("final_block", "trunk", "block2")
        m.dense("transformer.input_projection", "transformer", "in_proj")
        pe = m.take("transformer.positional_encoding")
        if pe is not None:
            m._set(m.params, ("transformer", "pos_embedding"), pe.reshape(pe.shape[-2:]))
        m.transformer_layers("transformer.transformer", d=512)
        m.dense("transformer.output_projection", "transformer", "out_proj")
        m.fmsl("fmsl_system", "fmsl")
    elif model_name == "maze2_fmsl":
        # maze2_fmsl_standardized.py:394-487 under fixed semantics: blocks with
        # bias-free convs and an internal SE; the dead lazy projection dropped
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.bn("first_bn", "first_bn")
        for i in range(3):
            m.res_block_plain(f"block{i}", "trunk", f"block{i}", first=(i == 0))
            if any(k.startswith(f"block{i}.se.") for k in m.sd):
                m.se(f"block{i}.se", "trunk", f"block{i}", "se")
        m.sd.pop("fmsl_projection.weight", None)
        m.sd.pop("fmsl_projection.bias", None)
        m.fmsl("fmsl_system", "fmsl")
    elif model_name == "maze3":
        # maze3.py:101-164: projection, three maze3 blocks (internal SE,
        # 'shortcut' skip), an MLP classifier with ReLU
        m.w2v2_backbone(w2v2_arch)
        m.conv("feature_projection", "proj")
        m.res_block("blocks.0", "trunk", "block0", first=True, skip_key="shortcut")
        m.res_block("blocks.1", "trunk", "block1", skip_key="shortcut")
        m.res_block("final_block", "trunk", "block2", skip_key="shortcut")
        m.dense("classifier.0", "fc1")
        m.dense("classifier.3", "fc2")
    else:
        raise ValueError(
            f"no torch->flax mapping for {model_name!r} (all 16 reference models are "
            f"supported; maze2_fmsl ports under fixed semantics: its reference forward "
            f"crashes on its own FMSL input-dim bug, maze2_fmsl_standardized.py:466-470)")

    report = {"missing": list(m.missing), "unconsumed": sorted(m.sd)}
    if n_gru is not None:
        report["gru_layers"] = n_gru
    return m.params, m.stats, report


def reference_parity_experiment(model_name: str, drift: bool = True) -> ExperimentConfig:
    """The configuration under which a ported reference checkpoint evaluates
    as the torch reference does (adfmsl :491-504): the 'reference' sinc
    formula and block semantics, f32 end to end, and for maze6_fmsl the FMSL
    head's 'fallback' mode (its literal live path, maze6_fmsl_standardized.py:
    345-361)."""
    from adfmsl_torch.config.standardized import make_experiment

    exp = make_experiment(model_name, drift=drift)
    exp.model.architecture.sinc_formula = "reference"
    exp.model.architecture.block_semantics = "reference"
    exp.model.dtype = "float32"
    if model_name == "maze6_fmsl" and exp.model.fmsl is not None:
        exp.model.fmsl.mode = "fallback"
    return exp


def merge(template: Mapping[str, torch.Tensor], ported: Mapping[str, torch.Tensor]
          ) -> "OrderedDict[str, torch.Tensor]":
    """``template`` (a freshly built model's ``state_dict()``) with the
    ``ported`` tensors laid over it, shapes checked; entries absent from
    ``ported`` keep their values (adfmsl ``merge_params`` :507-526, the
    strict=False analog). Ported keys the template lacks are ignored, as
    adfmsl's tree merge ignores them."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, tv in template.items():
        pv = ported.get(k)
        if pv is None:
            out[k] = tv
            continue
        if tuple(pv.shape) != tuple(tv.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(pv.shape)} vs "
                             f"model {tuple(tv.shape)}")
        out[k] = pv.to(dtype=tv.dtype, device=tv.device)
    return out
