"""Reference of the Wav2Vec2 maze models with fused encoder taps (the thesis's
maze6: ``maze6.py:182-267``).

The encoder is Wav2Vec2 (Baevski et al. 2020) as the HF ``Wav2Vec2Model``
computes it for a 'group' feature-norm, post-LN checkpoint: per-utterance
normalisation, the conv feature extractor (GroupNorm on layer 0, exact GELU),
LayerNorm + feature projection, the grouped positional conv (its last step
dropped for an even kernel) added, LayerNorm, then post-LN transformer layers.
The head concatenates the hidden states at ``taps`` (index clamped to the last
layer), fuses them with a 1x1 conv to ``proj_dim``, then BN -> act, the 'tpu'
SE-residual blocks, BN, a post-LN ReLU transformer, attentive statistics
pooling, fc1, fc2 and the raw logit score. Every conv and dense of the
encoder, the fusion, the trunk and the transformer is a bfloat16 product of
the configuration; the pooling and the classifier are float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import ops


def _lin(x, sd, name, prec, low=True):
    return ops.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), prec, low)


def attention(x, sd, name, heads, prec, dropout=None):
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_lin(x, sd, f"{name}.{n}", prec).view(b, t, heads, hd).transpose(1, 2)
               for n in ("query", "key", "value"))
    w = torch.softmax(prec.q(q / math.sqrt(hd), True) @ prec.q(k, True).transpose(-1, -2), -1)
    if dropout is not None:
        w = dropout(w)
    o = (prec.q(w, True) @ prec.q(v, True)).transpose(1, 2).reshape(b, t, d)
    return _lin(o, sd, f"{name}.out", prec)


def encoder(sd, x, w, prec):
    """(B, T) waveform -> the hidden states [embedding, layer 1, ..., layer L]."""
    eps = w["layer_norm_eps"]
    x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True)
                                                   + 1e-7)
    h = x[:, None, :]
    p = "wav2vec2.feature_extractor.conv_layers_"
    for i, stride in enumerate(w["conv_stride"]):
        h = ops.conv(h, sd[f"{p}{i}.conv.weight"], None, prec, True, stride=stride)
        if i == 0:
            gn = f"{p}0.group_norm"
            h = F.group_norm(h, sd[f"{gn}.weight"].shape[0], sd[f"{gn}.weight"],
                             sd[f"{gn}.bias"], eps)
        h = F.gelu(h)
    h = h.transpose(1, 2)
    h = _lin(ops.layer_norm(h, sd, "wav2vec2.feature_projection_norm", eps), sd,
             "wav2vec2.feature_projection", prec)
    kp = w["num_conv_pos_embeddings"]
    pos = ops.conv(h.transpose(1, 2), sd["wav2vec2.pos_conv_embed.conv.weight"],
                   sd["wav2vec2.pos_conv_embed.conv.bias"], prec, True, padding=kp // 2,
                   groups=w["num_conv_pos_embedding_groups"])
    if kp % 2 == 0:
        pos = pos[:, :, :-1]
    h = ops.layer_norm(h + F.gelu(pos).transpose(1, 2), sd, "wav2vec2.encoder_layer_norm",
                       eps)
    states = [h]
    for i in range(w["num_hidden_layers"]):
        n = f"wav2vec2.layers_{i}"
        h = ops.layer_norm(h + attention(h, sd, f"{n}.attention", w["num_attention_heads"],
                                         prec), sd, f"{n}.layer_norm", eps)
        ff = _lin(F.gelu(_lin(h, sd, f"{n}.intermediate_dense", prec)), sd,
                  f"{n}.output_dense", prec)
        h = ops.layer_norm(h + ff, sd, f"{n}.final_layer_norm", eps)
        states.append(h)
    return states


def transformer(h, sd, cfg, prec):
    """Post-LN layers with a ReLU FFN (torch ``nn.TransformerEncoderLayer``)."""
    tr = cfg["transformer"]
    for i in range(tr["layers"]):
        n = f"transformer.layer{i}"
        h = ops.layer_norm(h + attention(h, sd, f"{n}.self_attn", tr["heads"], prec), sd,
                           f"{n}.norm1", 1e-6)
        ff = _lin(torch.relu(_lin(h, sd, f"{n}.ff1", prec)), sd, f"{n}.ff2", prec)
        h = ops.layer_norm(h + ff, sd, f"{n}.norm2", 1e-6)
    return h


def asp(h, sd):
    """Attentive statistics pooling over time: weighted mean || weighted std."""
    a = torch.tanh(h @ sd["asp.att1.weight"].t() + sd["asp.att1.bias"])
    wt = torch.softmax(a @ sd["asp.att2.weight"].t() + sd["asp.att2.bias"], dim=1)
    mean = (wt * h).sum(1)
    var = (wt * (h - mean[:, None]) ** 2).sum(1)
    return torch.cat([mean, torch.sqrt(var + 1e-6)], -1)


def scores(sd, x, cfg, prec):
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


def frames(w, cut: int) -> list:
    """The feature extractor's output length after each conv layer."""
    t, out = cut, []
    for k, s in zip(w["conv_kernel"], w["conv_stride"]):
        t = ops.out_len(t, k, s)
        out.append(t)
    return out


def forward_flops(cfg, cut: int) -> float:
    """Products of one utterance's forward: extractor, projection, positional
    conv, the encoder layers (projections, scores, weighted sums, FFN), the
    tap fusion, the trunk, the transformer, the pooling and the classifier."""
    w = cfg["w2v2"]
    dims, ts = w["conv_dim"], frames(w, cut)
    total = sum(ops.conv_flops(t, dims[i - 1] if i else 1, dims[i], k)
                for i, (t, k) in enumerate(zip(ts, w["conv_kernel"])))
    t, h, f = ts[-1], w["hidden_size"], w["intermediate_size"]
    total += ops.linear_flops(t, dims[-1], h)
    total += ops.conv_flops(t, h, h, w["num_conv_pos_embeddings"],
                            w["num_conv_pos_embedding_groups"])

    def layer(t, d, ff):
        return (4 * ops.linear_flops(t, d, d) + 2 * 2.0 * t * t * d
                + ops.linear_flops(t, d, ff) + ops.linear_flops(t, ff, d))

    total += w["num_hidden_layers"] * layer(t, h, f)
    total += ops.conv_flops(t, h * len(cfg["taps"]), cfg["proj_dim"], 1)
    trunk, t2 = ops.trunk_flops(ops.blocks_of(cfg), t)
    tr, d = cfg["transformer"], cfg["blocks"][-1][1]
    total += trunk + tr["layers"] * layer(t2, d, tr["ff"])
    total += ops.linear_flops(t2, d, cfg["asp_hidden"]) + ops.linear_flops(t2, cfg["asp_hidden"], 1)
    total += ops.linear_flops(1, 2 * d, cfg["fc1"]) + ops.linear_flops(1, cfg["fc1"], 2)
    return total


def k1_calls(cfg, cut: int) -> list:
    return ops.k1_calls(ops.blocks_of(cfg), frames(cfg["w2v2"], cut)[-1])
