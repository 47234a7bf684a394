"""Wav2Vec2 encoder (port of ``adfmsl/models/w2v2.py``).

Raw waveform -> per-utterance zero-mean / unit-variance normalisation ->
conv feature extractor (VALID convs without bias, exact GELU; a GroupNorm on
layer 0 for 'group', a LayerNorm on every layer for 'layer') -> LayerNorm and
feature projection -> convolutional positional embedding (kernel 128, 16
groups, pad 64 a side, the last step trimmed for an even kernel) ->
transformer layers (post-LN, or pre-LN with ``do_stable_layer_norm``).

WavLM (Chen et al. 2021, HF ``modeling_wavlm.py``; ``num_buckets`` > 0) is
the same encoder with a gated relative-position bias in every layer's
scores. Layer 0's attention owns the bucket table ``rel_attn_embed``
(buckets, heads); the encoder builds the per-distance row (heads, 2T' - 1)
from it once a forward, from ``relative_position_bucket(j - i)``, and, where
the composition runs, the (heads, T', T') bias gathered from that row; it
passes one of them to every layer, broadcast over the batch. At eval in a
bf16 model on a card (``SelfAttention.fused``) each layer's attention core is
kernel K6 (``ops/wavlm_attention.py``), which adds the bias from the row
inside its tiles, and the (heads, T', T') table is never built. Each layer
scales the bias by a gate of its own,
per head and query frame, computed from its pre-LN input split into heads
(not from the query): ``g = a * (b * gru_rel_pos_const - 1) + 2`` with ``a, b``
the sigmoids of ``gru_rel_pos_linear``'s (head dim -> 8) output summed in two
groups of four, and adds ``g * bias`` to its scores before the softmax.

Numerics follow flax's rounding points, so the bf16 model matches adfmsl's:
convs and dense layers run in the model's dtype (input, kernel and bias cast
to it, the bias added after the product); LayerNorm / GroupNorm compute their
statistics in f32 (``E[x^2] - E[x]^2``, flax's fast variance) and return f32,
as flax's norms without ``dtype`` do for a bf16 input and f32 parameters;
attention is flax's ``MultiHeadDotProductAttention``: the query divided by
sqrt(head dim) in the compute dtype, the softmax in it, the weights in it.
WavLM's gate product (head dim -> 8) is a dense in the compute dtype too;
the bias, the gate, its sum with the scores (the product q.k rounded to the
compute dtype) and the softmax are f32, and the weights are rounded to the
compute dtype for the weighted sum.
Attention is written as explicit products; adfmsl computes it outside any
Pallas kernel, so these are library products. The extractor runs in (B, C, T),
the rest in adfmsl's (B, T, C).

``remat_layers`` checkpoints each transformer layer and ``remat_extractor``
the conv feature extractor (adfmsl :169-184, ``nn.remat``) through
``ops/remat.py:checkpoint``, in train mode under autograd; elsewhere they
change nothing. The parameters are the same with and without them.

Module names follow adfmsl's flax tree (``feature_extractor.conv_layers_{i}.
{conv,group_norm,layer_norm}``, ``feature_projection_norm``,
``feature_projection``, ``pos_conv_embed.conv``, ``encoder_layer_norm``,
``layers_{i}.{attention.{query,key,value,out},layer_norm,intermediate_dense,
output_dense,final_layer_norm}``), so ``models/port.py:state_dict_from_flax``
carries adfmsl's variables across. ``port_hf_state_dict`` (numpy only) maps a
local HF torch checkpoint onto that tree, and ``load_pretrained`` reads one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.ops import wavlm_attention as k6
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.remat import checkpoint, recomputing
from adfmsl_torch.utils.profiling import annotate, count


@dataclass(frozen=True)
class W2V2Arch:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "group"     # 'group' (base) | 'layer' (large-lv60/xlsr)
    do_stable_layer_norm: bool = False   # True for lv60-style checkpoints
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    num_buckets: int = 0                 # WavLM's relative-position buckets; 0: no bias
    max_bucket_distance: int = 0

    @staticmethod
    def base() -> "W2V2Arch":
        return W2V2Arch()

    @staticmethod
    def large_960h() -> "W2V2Arch":
        return W2V2Arch(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096)

    @staticmethod
    def tiny(num_heads: int = 2) -> "W2V2Arch":
        """For tests: 2 conv layers, 2 transformer layers (``num_heads=4``:
        adfmsl's 'tiny4')."""
        return W2V2Arch(hidden_size=64, num_layers=2, num_heads=num_heads,
                        intermediate_size=128, conv_dim=(32, 32),
                        conv_kernel=(10, 3), conv_stride=(5, 2))

    @staticmethod
    def wavlm_large() -> "W2V2Arch":
        """microsoft/wavlm-large (its ``config.json``): 24 pre-LN layers,
        'layer' feature norm, no conv bias, 320 buckets up to distance 800."""
        return W2V2Arch(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096, feat_extract_norm="layer",
                        do_stable_layer_norm=True, num_buckets=320,
                        max_bucket_distance=800)

    @staticmethod
    def tiny_wavlm() -> "W2V2Arch":
        """For tests: ``tiny``'s convs and 2 layers, 4 heads, 32 buckets up to
        distance 64 (the buckets saturate from distance 50 on)."""
        return W2V2Arch(hidden_size=64, num_layers=2, num_heads=4,
                        intermediate_size=128, conv_dim=(32, 32),
                        conv_kernel=(10, 3), conv_stride=(5, 2),
                        feat_extract_norm="layer", do_stable_layer_norm=True,
                        num_buckets=32, max_bucket_distance=64)


WAVLM_ARCHS = {"microsoft/wavlm-large": W2V2Arch.wavlm_large,
               "tiny_wavlm": W2V2Arch.tiny_wavlm}


def arch_for(cfg) -> W2V2Arch:
    """The encoder of a ``Wav2Vec2Config`` (adfmsl ``mazes.py:_w2v2_arch``):
    'tiny' / 'tiny4' by name, WavLM by name (``WAVLM_ARCHS``; any other name
    with 'wavlm' in it raises), else large from ``output_dim`` 1024, else base."""
    if cfg.model_name == "tiny":
        return W2V2Arch.tiny()
    if cfg.model_name == "tiny4":
        return W2V2Arch.tiny(num_heads=4)
    if cfg.model_name in WAVLM_ARCHS:
        return WAVLM_ARCHS[cfg.model_name]()
    if "wavlm" in cfg.model_name.lower():
        raise ValueError(f"unsupported WavLM model {cfg.model_name!r}; supported: "
                         f"{sorted(WAVLM_ARCHS)}")
    if cfg.output_dim >= 1024:
        return W2V2Arch.large_960h()
    return W2V2Arch.base()


def flax_norm(x: torch.Tensor, dims, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """flax LayerNorm / GroupNorm numerics: statistics over ``dims`` in f32
    (variance ``max(0, E[x^2] - E[x]^2)``), then ``(x - mean) * (rsqrt(var +
    eps) * weight) + bias`` in f32. ``weight`` and ``bias`` come shaped to
    broadcast against ``x``."""
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = torch.clamp((xf * xf).mean(dims, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """WavLM's bucket (int64) of each relative position ``rel`` = j - i, as HF
    ``WavLMAttention._relative_positions_bucket`` computes it: half the
    buckets for j > i; distances under a quarter of them exact, longer ones
    log-spaced up to ``max_distance``, then the last bucket of the half."""
    n = num_buckets // 2
    e = n // 2
    r = rel.abs()
    large = (e + torch.log(r.float() / e) / math.log(max_distance / e) * (n - e)).long()
    return (rel > 0).long() * n + torch.where(r < e, r, torch.clamp(large, max=n - 1))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis (f32 out)."""
    return flax_norm(x, (-1,), ln.weight, ln.bias, ln.eps)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: the product in ``dtype``, then the bias."""
    return torch.matmul(x.to(dtype), lin.weight.to(dtype).t()) + lin.bias.to(dtype)


class _ConvLayer(nn.Module):
    def __init__(self, arch: W2V2Arch, index: int):
        super().__init__()
        cin = 1 if index == 0 else arch.conv_dim[index - 1]
        cout = arch.conv_dim[index]
        self.stride = arch.conv_stride[index]
        self.eps = arch.layer_norm_eps
        self.conv = nn.Conv1d(cin, cout, arch.conv_kernel[index], stride=self.stride,
                              bias=False)
        if arch.feat_extract_norm == "group" and index == 0:
            self.group_norm = nn.GroupNorm(cout, cout, eps=self.eps)
        elif arch.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(cout, eps=self.eps)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, Cin, T) -> (B, Cout, T')."""
        h = F.conv1d(x.to(dtype), self.conv.weight.to(dtype), stride=self.stride)
        if hasattr(self, "group_norm"):
            gn = self.group_norm
            b, c, t = h.shape
            g = gn.num_groups
            h = flax_norm(h.reshape(b, g, c // g, t), (2, 3),
                          gn.weight.reshape(1, g, c // g, 1),
                          gn.bias.reshape(1, g, c // g, 1), self.eps).reshape(b, c, t)
        elif hasattr(self, "layer_norm"):
            ln = self.layer_norm
            h = flax_norm(h, (1,), ln.weight[:, None], ln.bias[:, None], self.eps)
        return F.gelu(h)


class _FeatureExtractor(nn.Module):
    def __init__(self, arch: W2V2Arch):
        super().__init__()
        self.n = len(arch.conv_dim)
        for i in range(self.n):
            self.add_module(f"conv_layers_{i}", _ConvLayer(arch, i))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T) raw audio -> (B, T', conv_dim[-1])."""
        h = x[:, None, :]
        for i in range(self.n):
            h = getattr(self, f"conv_layers_{i}")(h, dtype)
        return h.transpose(1, 2)


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, arch: W2V2Arch):
        super().__init__()
        k = arch.num_conv_pos_embeddings
        self.conv = nn.Conv1d(arch.hidden_size, arch.hidden_size, k, padding=k // 2,
                              groups=arch.num_conv_pos_embedding_groups)
        self.trim = k % 2 == 0              # HF pads SAME, then drops one step

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        c = self.conv
        xd, w, b = x.transpose(1, 2).to(dtype), c.weight.to(dtype), c.bias.to(dtype)
        if x.device.type == "cpu" and dtype == torch.bfloat16:
            # torch's CPU bf16 grouped conv is wrong at 4 channels a group
            # (the tiny arch): take the f32 product of the bf16 operands,
            # rounded once, which is what a bf16 conv accumulating in f32 gives
            h = F.conv1d(xd.float(), w.float(), b.float(), padding=c.padding,
                         groups=c.groups).to(dtype)
        else:
            h = F.conv1d(xd, w, b, padding=c.padding, groups=c.groups)
        if self.trim:
            h = h[:, :, :-1]
        return F.gelu(h.transpose(1, 2))


def row_parallel_dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
                       group) -> torch.Tensor:
    """``dense`` of a row-parallel shard (``parallel/tp.py``): the partial
    products of the ``dtype`` operands summed over the model group in f32,
    rounded to ``dtype`` once, then the whole bias, added once."""
    from adfmsl_torch.parallel.collectives import reduce_from_model

    part = torch.matmul(x.to(dtype).float(), lin.weight.to(dtype).float().t())
    return reduce_from_model(part, group).to(dtype) + lin.bias.to(dtype)


def _enter_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    from adfmsl_torch.parallel.collectives import copy_to_model

    return x if group is None else copy_to_model(x, group)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask) with its
    DenseGeneral projections held as (H, H) linears. In train mode with a
    ``dropout_rate`` the attention weights take dropout from ``generator``.
    Split for tensor parallelism (``parallel/tp.py``: ``tp_group`` set) it
    holds ``heads`` of the heads, from head ``head0`` on, and ``out`` is
    row-parallel.

    WavLM's form (``gated``) owns ``gru_rel_pos_linear`` and
    ``gru_rel_pos_const``, and with ``num_buckets`` (layer 0) the bucket table
    ``rel_attn_embed``; its forward takes the encoder's (heads, T, T) ``bias``
    for the composition, or where ``fused`` holds its per-distance ``row``
    (heads, 2T - 1) for kernel K6."""

    def __init__(self, hidden: int, heads: int, gated: bool = False, num_buckets: int = 0):
        super().__init__()
        self.heads = heads
        self.head_dim = hidden // heads
        self.head0 = 0
        self.tp_group = None
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(hidden, hidden))
        if gated:
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        if num_buckets:
            self.rel_attn_embed = nn.Embedding(num_buckets, heads)

    def fused(self, x: torch.Tensor, dtype: torch.dtype) -> bool:
        """Whether kernel K6 computes this layer's gated attention for the
        input ``x``: WavLM's form at eval (so no dropout) with grad disabled
        (K6 has no backward) in a bf16 model on a card, at K6's head dim.
        Elsewhere (training and remat, dropout, grad on, f32, the CPU,
        wav2vec2's bias-free form) the composition runs."""
        return (hasattr(self, "gru_rel_pos_linear") and x.is_cuda
                and dtype == torch.bfloat16 and not torch.is_grad_enabled()
                and not self.training and self.head_dim == k6.HEAD_DIM)

    def gate(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """WavLM's gate (B, heads, T), f32, of the layer's pre-LN input
        ``x`` (B, T, H) split into heads: the head dim -> 8 product in
        ``dtype``, then in f32 its two groups of four summed, their sigmoids
        ``a, b`` and ``a * (b * gru_rel_pos_const - 1) + 2``. Under tensor
        parallelism the linear's weights enter the split region through
        Megatron's f, so each rank's gradient of them is summed over the heads
        of every rank."""
        b, t, _ = x.shape
        hd = self.head_dim
        xh = x[..., self.head0 * hd:(self.head0 + self.heads) * hd].reshape(
            b, t, self.heads, hd).transpose(1, 2)
        lin = self.gru_rel_pos_linear
        w, bias = (_enter_model_parallel(p, self.tp_group) for p in (lin.weight, lin.bias))
        p = torch.matmul(xh.to(dtype), w.to(dtype).t()) + bias.to(dtype)
        ga, gb = torch.sigmoid(p.float().view(b, self.heads, t, 2, 4).sum(-1)).unbind(-1)
        return ga * (gb * self.gru_rel_pos_const.view(1, self.heads, 1) - 1.0) + 2.0

    def forward(self, x: torch.Tensor, dtype: torch.dtype, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                bias: Optional[torch.Tensor] = None,
                row: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        hd = self.head_dim
        x = _enter_model_parallel(x, self.tp_group)
        q, k, v = (dense(x, getattr(self, n), dtype) for n in ("query", "key", "value"))
        if row is not None:
            if not self.fused(x, dtype):
                raise ValueError("SelfAttention: the bias row is K6's operand; K6 does not "
                                 "take this call (SelfAttention.fused)")
            count("w2v2.gated_layers")
            with annotate("stage.w2v2.attention"):
                with annotate("stage.w2v2.gate"):
                    g = self.gate(x, dtype)
                o = k6.wavlm_attention(q, k, v, g, row)
        elif bias is not None:
            q = k6.scale_query(q, hd)
            if not recomputing():
                count("w2v2.gated_layers")
            with annotate("stage.w2v2.attention"):
                with annotate("stage.w2v2.gate"):
                    g = self.gate(x, dtype)
                o = k6.attention_composition(q, k, v, g, bias, dropout_rate, generator,
                                             self.training)
        else:
            q, k, v = (y.view(b, t, self.heads, hd).transpose(1, 2)
                       for y in (k6.scale_query(q, hd), k, v))
            w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
            w = dropout(w, dropout_rate, generator, self.training)
            o = torch.matmul(w, v).transpose(1, 2).reshape(b, t, self.heads * hd)
        if self.tp_group is not None:
            return row_parallel_dense(o, self.out, dtype, self.tp_group)
        return dense(o, self.out, dtype)


class _EncoderLayer(nn.Module):
    def __init__(self, arch: W2V2Arch, index: int = 0):
        super().__init__()
        h, eps = arch.hidden_size, arch.layer_norm_eps
        self.pre = arch.do_stable_layer_norm
        gated = arch.num_buckets > 0
        self.attention = SelfAttention(h, arch.num_heads, gated=gated,
                                       num_buckets=arch.num_buckets if index == 0 else 0)
        self.layer_norm = nn.LayerNorm(h, eps=eps)
        self.intermediate_dense = nn.Linear(h, arch.intermediate_size)
        self.output_dense = nn.Linear(arch.intermediate_size, h)
        self.final_layer_norm = nn.LayerNorm(h, eps=eps)
        self.tp_group = None        # set by parallel/tp.py: the FFN is split

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                bias: Optional[torch.Tensor] = None,
                row: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = layer_norm(x, self.layer_norm) if self.pre else x
        x = x + self.attention(h, dtype, bias=bias, row=row)
        if not self.pre:
            x = layer_norm(x, self.layer_norm)
        h = layer_norm(x, self.final_layer_norm) if self.pre else x
        h = F.gelu(dense(_enter_model_parallel(h, self.tp_group), self.intermediate_dense,
                         dtype))
        if self.tp_group is not None:
            h = row_parallel_dense(h, self.output_dense, dtype, self.tp_group)
        else:
            h = dense(h, self.output_dense, dtype)
        x = x + h
        if not self.pre:
            x = layer_norm(x, self.final_layer_norm)
        return x


class Wav2Vec2Encoder(nn.Module):
    """Raw waveform (B, T) f32 -> last hidden state (B, T', H), with
    ``output_hidden_states`` also the list of the embedding's and every
    layer's output (HF's ``hidden_states``). ``normalize_input`` applies the
    Wav2Vec2Processor's per-utterance normalisation, var + 1e-7.
    ``remat_layers`` / ``remat_extractor`` checkpoint the transformer layers /
    the conv feature extractor in training. With WavLM's bias the forward
    counts ``w2v2.relpos_bias`` once and ``w2v2.gated_layers`` once a layer
    (not again in a recompute), and ``w2v2.fused_attention`` once a K6 launch,
    inside the spans ``stage.w2v2.relpos`` (the per-distance row, and where
    the composition runs the bias table gathered from it),
    ``stage.w2v2.attention`` (each layer's scores to its weighted sum: K6, or
    the composition) and ``stage.w2v2.gate`` (in it: the gate alone)."""

    def __init__(self, arch: W2V2Arch = W2V2Arch(), normalize_input: bool = True,
                 dtype: torch.dtype = torch.float32, remat_layers: bool = False,
                 remat_extractor: bool = False):
        super().__init__()
        self.arch, self.normalize_input, self.dtype = arch, normalize_input, dtype
        self.remat_layers, self.remat_extractor = remat_layers, remat_extractor
        h, eps = arch.hidden_size, arch.layer_norm_eps
        self.feature_extractor = _FeatureExtractor(arch)
        self.feature_projection_norm = nn.LayerNorm(arch.conv_dim[-1], eps=eps)
        self.feature_projection = nn.Linear(arch.conv_dim[-1], h)
        self.pos_conv_embed = _PositionalConvEmbedding(arch)
        self.encoder_layer_norm = nn.LayerNorm(h, eps=eps)
        for i in range(arch.num_layers):
            self.add_module(f"layers_{i}", _EncoderLayer(arch, i))

    def relative_position_row(self, t: int) -> torch.Tensor:
        """WavLM's bias by distance (heads, 2t - 1), f32: entry t - 1 + d is
        layer 0's ``rel_attn_embed`` row of ``relative_position_bucket(d)``,
        for d = j - i from 1 - t to t - 1."""
        a, table = self.arch, self.layers_0.attention.rel_attn_embed.weight
        rel = torch.arange(1 - t, t, device=table.device)
        bucket = relative_position_bucket(rel, a.num_buckets, a.max_bucket_distance)
        return table.float()[bucket].t().contiguous()

    def position_bias(self, t: int) -> torch.Tensor:
        """WavLM's relative-position bias (heads, t, t), f32, for query frame
        i and key frame j: ``relative_position_row``'s entry t - 1 + j - i,
        so the composition adds the values K6 adds."""
        return k6.bias_from_row(self.relative_position_row(t), t)

    def forward(self, x: torch.Tensor, output_hidden_states: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
        a, dt = self.arch, self.dtype
        if self.normalize_input:
            mean = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, unbiased=False, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-7)
        if self.remat_extractor and self.training:
            h = checkpoint(self.feature_extractor, x, dt)
        else:
            h = self.feature_extractor(x, dt)
        h = dense(layer_norm(h, self.feature_projection_norm), self.feature_projection, dt)
        h = h + self.pos_conv_embed(h, dt)
        if not a.do_stable_layer_norm:
            h = layer_norm(h, self.encoder_layer_norm)
        hidden_states = [h]
        bias = row = None
        if a.num_buckets:
            with annotate("stage.w2v2.relpos"):
                if self.layers_0.attention.fused(h, dt):
                    row = self.relative_position_row(h.shape[1])
                else:
                    bias = self.position_bias(h.shape[1])
            count("w2v2.relpos_bias")
        remat = self.remat_layers and self.training
        for i in range(a.num_layers):
            layer = getattr(self, f"layers_{i}")
            h = checkpoint(layer, h, dt, bias) if remat else layer(h, dt, bias, row)
            hidden_states.append(h)
        if a.do_stable_layer_norm:
            h = layer_norm(h, self.encoder_layer_norm)
            hidden_states[-1] = h
        return (h, hidden_states) if output_hidden_states else h


# ---------------------------------------------------------------------------------
# HF torch checkpoint porting (numpy only: the tree is adfmsl's flax layout)
# ---------------------------------------------------------------------------------

def _t(x):
    return np.ascontiguousarray(np.asarray(x))


def port_hf_state_dict(sd: dict, arch: W2V2Arch) -> dict:
    """Map a HF torch Wav2Vec2Model or WavLMModel state_dict (numpy values,
    keys under 'feature_extractor'/'feature_projection'/'encoder', optionally
    prefixed 'wav2vec2.' or 'wavlm.') to adfmsl's flax param tree of the
    encoder, as numpy arrays (adfmsl ``w2v2.py:205``). ``state_dict_from_flax``
    turns the tree into the port's state dict. WavLM's leaves (``num_buckets``
    > 0), which adfmsl has no tree for, go under each layer's ``attention``:
    ``gru_rel_pos_linear`` as a Dense, ``gru_rel_pos_const`` bare, and layer
    0's ``rel_attn_embed`` as ``{"weight": (buckets, heads)}``."""
    prefixes = ("wav2vec2.", "wavlm.")
    sd = {next((k[len(p):] for p in prefixes if k.startswith(p)), k): v
          for k, v in sd.items()}

    def norm(key):
        return {"scale": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])}

    p: dict = {}
    fe: dict = {}
    for i in range(len(arch.conv_dim)):
        c = f"feature_extractor.conv_layers.{i}"
        layer: dict = {"conv": {"kernel": _t(sd[f"{c}.conv.weight"]).transpose(2, 1, 0)}}
        if arch.feat_extract_norm == "group" and i == 0:
            layer["group_norm"] = norm(f"{c}.layer_norm")
        elif arch.feat_extract_norm == "layer":
            layer["layer_norm"] = norm(f"{c}.layer_norm")
        fe[f"conv_layers_{i}"] = layer
    p["feature_extractor"] = fe
    p["feature_projection_norm"] = norm("feature_projection.layer_norm")
    p["feature_projection"] = {
        "kernel": _t(sd["feature_projection.projection.weight"]).T,
        "bias": _t(sd["feature_projection.projection.bias"]),
    }

    # positional conv: HF stores weight-norm (weight_g, weight_v, or the
    # parametrizations spelling) or a plain weight
    base = "encoder.pos_conv_embed.conv"
    spellings = ((f"{base}.weight_g", f"{base}.weight_v"),
                 (f"{base}.parametrizations.weight.original0",
                  f"{base}.parametrizations.weight.original1"))
    found = [s for s in spellings if s[0] in sd]
    if found:
        g, v = _t(sd[found[0][0]]), _t(sd[found[0][1]])   # weight_norm dim=2: g (1,1,K)
        nrm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
        w = v * (g.reshape(1, 1, -1) / np.maximum(nrm, 1e-12))
    else:
        w = _t(sd[f"{base}.weight"])
    p["pos_conv_embed"] = {"conv": {"kernel": w.transpose(2, 1, 0),
                                    "bias": _t(sd[f"{base}.bias"])}}
    p["encoder_layer_norm"] = norm("encoder.layer_norm")

    H, nH = arch.hidden_size, arch.num_heads
    hd = H // nH
    for i in range(arch.num_layers):
        e = f"encoder.layers.{i}"

        def qkv(name):
            return {"kernel": _t(sd[f"{e}.attention.{name}.weight"]).T.reshape(H, nH, hd),
                    "bias": _t(sd[f"{e}.attention.{name}.bias"]).reshape(nH, hd)}
        p[f"layers_{i}"] = {
            "attention": {
                "query": qkv("q_proj"), "key": qkv("k_proj"), "value": qkv("v_proj"),
                "out": {
                    "kernel": _t(sd[f"{e}.attention.out_proj.weight"]).T.reshape(nH, hd, H),
                    "bias": _t(sd[f"{e}.attention.out_proj.bias"]),
                },
            },
            "layer_norm": norm(f"{e}.layer_norm"),
            "intermediate_dense": {
                "kernel": _t(sd[f"{e}.feed_forward.intermediate_dense.weight"]).T,
                "bias": _t(sd[f"{e}.feed_forward.intermediate_dense.bias"]),
            },
            "output_dense": {
                "kernel": _t(sd[f"{e}.feed_forward.output_dense.weight"]).T,
                "bias": _t(sd[f"{e}.feed_forward.output_dense.bias"]),
            },
            "final_layer_norm": norm(f"{e}.final_layer_norm"),
        }
        if arch.num_buckets:
            att = p[f"layers_{i}"]["attention"]
            a = f"{e}.attention"
            att["gru_rel_pos_linear"] = {
                "kernel": _t(sd[f"{a}.gru_rel_pos_linear.weight"]).T,
                "bias": _t(sd[f"{a}.gru_rel_pos_linear.bias"]),
            }
            att["gru_rel_pos_const"] = _t(sd[f"{a}.gru_rel_pos_const"])
            if i == 0:
                att["rel_attn_embed"] = {"weight": _t(sd[f"{a}.rel_attn_embed.weight"])}
    return p


def read_hf_state_dict(path: str) -> "dict[str, np.ndarray]":
    """A local HF checkpoint (.safetensors, torch .bin / .pt) as numpy arrays."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs the 'safetensors' package") from e
        return load_file(path)
    return {k: v.numpy() for k, v in torch.load(path, map_location="cpu",
                                                weights_only=True).items()}


def load_pretrained(path: str, arch: W2V2Arch) -> "dict[str, torch.Tensor]":
    """A local HF checkpoint (.safetensors, torch .bin / .pt) -> the port's
    state dict of ``Wav2Vec2Encoder`` (adfmsl ``w2v2.py:294``, which returns
    the flax tree: here it goes on through ``state_dict_from_flax``)."""
    from adfmsl_torch.models.port import flax_tree_to_state_dict

    return flax_tree_to_state_dict(port_hf_state_dict(read_hf_state_dict(path), arch))
