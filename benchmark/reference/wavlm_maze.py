"""Reference of maze6's head on a WavLM-Large encoder (Chen et al. 2021,
"WavLM: Large-Scale Self-Supervised Pre-Training for Full Stack Speech
Processing", arXiv:2110.13900; microsoft/wavlm-large's ``config.json``; the
head of the thesis's ``maze6.py:182-267``).

The encoder is HF's ``WavLMModel`` for a 'layer' feature-norm, stable
layer-norm checkpoint: per-utterance normalisation; the conv feature
extractor, each conv (no bias) followed by a LayerNorm over its channels and
exact GELU; LayerNorm + feature projection; the grouped positional conv (its
last step dropped for an even kernel) through GELU, added, with no LayerNorm
after it; pre-LN layers; the final LayerNorm on the last layer's output. Each
layer's attention adds a gated relative-position bias to its scores: for head
h, query frame i, key frame j, ``g[b,h,i] * E[bucket(j - i), h]``, with ``E``
layer 0's ``rel_attn_embed`` (buckets, heads), shared by every layer, and the
gate ``g = a * (b * c_h - 1) + 2`` from the layer's own ``gru_rel_pos_linear``
(head dim -> 8) on its pre-LN input split into heads (not the query), the 8
outputs summed in two groups of four, ``a, b`` their sigmoids, ``c`` its
``gru_rel_pos_const``. The head (taps, 1x1 fusion, blocks, transformer, ASP,
fc1, fc2) is ``w2v2_maze``'s.

Rounding points of the bfloat16 configuration (``Prec.q(..., True)``): every
conv's and dense's operands and result, the gate's product among them; the
scaled query, the keys and the scores q.k; the softmax's weights and the
values. The bias, the gate, their product and its sum with the scores, and the
softmax are float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import ops, w2v2_maze
from reference.w2v2_maze import _lin, asp, frames, transformer

TABLE = "wav2vec2.layers_0.attention.rel_attn_embed.weight"


def bucket(rel, num_buckets: int, max_distance: int):
    """The relative-position bucket of each distance ``rel`` = j - i (int64):
    half the buckets for j > i; distances under a quarter of them exact,
    longer ones log-spaced to ``max_distance``, then the half's last."""
    half = num_buckets // 2
    exact = half // 2
    n = rel.abs()
    far = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                   * (half - exact)).long()
    far = torch.minimum(far, torch.full_like(far, half - 1))
    return torch.where(rel > 0, half, 0) + torch.where(n < exact, n, far)


def relative_bias(sd, t: int, w):
    """The ungated bias (heads, T, T), float32."""
    pos = torch.arange(t, device=sd[TABLE].device)
    rel = pos[None, :] - pos[:, None]
    return sd[TABLE][bucket(rel, w["num_buckets"], w["max_bucket_distance"])].permute(2, 0, 1)


def attention(x, sd, name, heads, bias, prec):
    """One layer's self-attention with its gated bias; ``x`` is the pre-LN
    input."""
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_lin(x, sd, f"{name}.{n}", prec).view(b, t, heads, hd).transpose(1, 2)
               for n in ("query", "key", "value"))
    xh = x.view(b, t, heads, hd).transpose(1, 2)
    p = _lin(xh, sd, f"{name}.gru_rel_pos_linear", prec).view(b, heads, t, 2, 4).sum(-1)
    ga, gb = torch.sigmoid(p).chunk(2, dim=-1)
    gate = ga * (gb * sd[f"{name}.gru_rel_pos_const"] - 1.0) + 2.0
    s = prec.q(prec.q(q / math.sqrt(hd), True) @ prec.q(k, True).transpose(-1, -2), True)
    w = torch.softmax(s + gate * bias[None], -1)
    o = (prec.q(w, True) @ prec.q(v, True)).transpose(1, 2).reshape(b, t, d)
    return _lin(o, sd, f"{name}.out", prec)


def encoder(sd, x, w, prec):
    """(B, T) waveform -> the hidden states [embedding, layer 1, ..., layer L],
    the last after the final LayerNorm."""
    if TABLE not in sd:
        raise KeyError(f"the program has no {TABLE!r}: it did not build WavLM's "
                       "relative-position bias")
    eps = w["layer_norm_eps"]
    x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True)
                                                   + 1e-7)
    h = x[:, None, :]
    p = "wav2vec2.feature_extractor.conv_layers_"
    for i, stride in enumerate(w["conv_stride"]):
        h = ops.conv(h, sd[f"{p}{i}.conv.weight"], None, prec, True, stride=stride)
        h = F.gelu(ops.layer_norm(h.transpose(1, 2), sd, f"{p}{i}.layer_norm",
                                  eps).transpose(1, 2))
    h = h.transpose(1, 2)
    h = _lin(ops.layer_norm(h, sd, "wav2vec2.feature_projection_norm", eps), sd,
             "wav2vec2.feature_projection", prec)
    kp = w["num_conv_pos_embeddings"]
    pos = ops.conv(h.transpose(1, 2), sd["wav2vec2.pos_conv_embed.conv.weight"],
                   sd["wav2vec2.pos_conv_embed.conv.bias"], prec, True, padding=kp // 2,
                   groups=w["num_conv_pos_embedding_groups"])
    if kp % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    bias = relative_bias(sd, h.shape[1], w)
    states = [h]
    for i in range(w["num_hidden_layers"]):
        n = f"wav2vec2.layers_{i}"
        h = h + attention(ops.layer_norm(h, sd, f"{n}.layer_norm", eps), sd,
                          f"{n}.attention", w["num_attention_heads"], bias, prec)
        ff = _lin(F.gelu(_lin(ops.layer_norm(h, sd, f"{n}.final_layer_norm", eps), sd,
                              f"{n}.intermediate_dense", prec)), sd, f"{n}.output_dense", prec)
        h = h + ff
        states.append(h)
    states[-1] = ops.layer_norm(h, sd, "wav2vec2.encoder_layer_norm", eps)
    return states


def scores(sd, x, cfg, prec):
    """maze6's head (``w2v2_maze.scores`` after its encoder) on WavLM's states."""
    states = encoder(sd, x, cfg["w2v2"], prec)
    last = len(states) - 1
    h = torch.cat([states[min(i, last)] for i in cfg["taps"]], -1).transpose(1, 2)
    h = ops.conv(h, sd["proj.weight"], sd["proj.bias"], prec, True)
    act = F.selu if cfg["first_bn_act"] == "selu" else torch.relu
    h = prec.q(act(ops.bn_eval(h, sd, "first_bn")), True)
    for i, (_, _, stride) in enumerate(ops.blocks_of(cfg)):
        h = ops.resblock(h, sd, f"trunk.block{i}", stride, i == 0, prec)
    h = ops.bn_eval(h, sd, "bn_before_transformer").transpose(1, 2)
    p = asp(transformer(h, sd, cfg, prec), sd)
    logits = (p @ sd["fc1.weight"].t() + sd["fc1.bias"]) @ sd["fc2.weight"].t() + sd["fc2.bias"]
    return ops.score_of(logits, cfg["score"])


def forward_flops(cfg, cut: int) -> float:
    """``w2v2_maze.forward_flops`` (the same convs, projections, T'^2 scores
    and weighted sums, FFN and head) plus each layer's gate product, head dim
    -> 8 at every frame and head."""
    w = cfg["w2v2"]
    t = frames(w, cut)[-1]
    gate = ops.linear_flops(t * w["num_attention_heads"],
                            w["hidden_size"] // w["num_attention_heads"], 8)
    return w2v2_maze.forward_flops(cfg, cut) + w["num_hidden_layers"] * gate


def k1_calls(cfg, cut: int) -> list:
    return w2v2_maze.k1_calls(cfg, cut)
