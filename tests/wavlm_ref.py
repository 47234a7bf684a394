"""A plain float32 WavLM encoder (Chen et al. 2021, "WavLM: Large-Scale
Self-Supervised Pre-Training for Full Stack Speech Processing"; HF
``WavLMModel`` with ``do_stable_layer_norm`` and the 'layer' feature norm),
written from the paper's and HF's layer equations in plain torch. It imports
nothing of either package of the repository and nothing of JAX, and takes
its weights as a state dict under the port's encoder names
(``adfmsl_torch/models/w2v2.py``).

The forward: per-utterance normalisation (var + 1e-7); the conv feature
extractor, each conv (no bias) followed by a LayerNorm over channels and
GELU; LayerNorm and the feature projection; the grouped positional conv (its
last step dropped for an even kernel) through GELU, added, with no LayerNorm
after it; pre-LN layers whose attention adds the gated relative-position bias
to the scores; the final LayerNorm on the last layer's output.

The bias, for head h, query frame i and key frame j, is
``g[b,h,i] * E[bucket(j - i), h]``: ``E`` is layer 0's ``rel_attn_embed``
(buckets, heads), shared by every layer; the gate ``g = a * (b * c_h - 1) + 2``
comes from each layer's own ``gru_rel_pos_linear`` (head dim -> 8) applied to
its pre-LN input split into heads, the 8 outputs summed in two groups of
four, ``a, b`` their sigmoids, ``c`` its ``gru_rel_pos_const``.

``drop`` removes a part of the mechanism, for the tests that show the
mechanism is there: 'table' sets ``E`` to zero, 'gate' sets ``g`` to 1.
"""
import math

import torch
import torch.nn.functional as F


def bucket(rel, num_buckets, max_distance):
    """The relative-position bucket of each distance ``rel`` = j - i."""
    half = num_buckets // 2
    exact = half // 2
    n = rel.abs()
    far = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                   * (half - exact)).long()
    far = torch.minimum(far, torch.full_like(far, half - 1))
    return torch.where(rel > 0, half, 0) + torch.where(n < exact, n, far)


def _ln(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _lin(x, sd, name):
    return x @ sd[f"{name}.weight"].t() + sd[f"{name}.bias"]


def attention(x, sd, name, heads, table, drop=None):
    """One layer's self-attention with its gated bias; ``table`` is the
    (heads, T, T) ungated bias."""
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_lin(x, sd, f"{name}.{p}").view(b, t, heads, hd).transpose(1, 2)
               for p in ("query", "key", "value"))
    xh = x.view(b, t, heads, hd).transpose(1, 2)
    p = _lin(xh, sd, f"{name}.gru_rel_pos_linear").view(b, heads, t, 2, 4).sum(-1)
    a, g_b = torch.sigmoid(p).chunk(2, dim=-1)
    gate = a * (g_b * sd[f"{name}.gru_rel_pos_const"] - 1.0) + 2.0
    if drop == "gate":
        gate = torch.ones_like(gate)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd) + gate * table[None]
    o = torch.softmax(scores, dim=-1) @ v
    return _lin(o.transpose(1, 2).reshape(b, t, d), sd, f"{name}.out")


def hidden_states(sd, x, arch, drop=None, normalize=True):
    """(B, samples) -> [the embedding, layer 1, ..., layer L], the last after
    the final LayerNorm (HF's ``hidden_states``)."""
    eps = arch.layer_norm_eps
    if normalize:
        x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(
            x.var(-1, unbiased=False, keepdim=True) + 1e-7)
    h = x[:, None, :]
    for i, stride in enumerate(arch.conv_stride):
        n = f"feature_extractor.conv_layers_{i}"
        h = F.conv1d(h, sd[f"{n}.conv.weight"], stride=stride)
        h = F.gelu(_ln(h.transpose(1, 2), sd, f"{n}.layer_norm", eps).transpose(1, 2))
    h = _lin(_ln(h.transpose(1, 2), sd, "feature_projection_norm", eps), sd,
             "feature_projection")
    kp = arch.num_conv_pos_embeddings
    pos = F.conv1d(h.transpose(1, 2), sd["pos_conv_embed.conv.weight"],
                   sd["pos_conv_embed.conv.bias"], padding=kp // 2,
                   groups=arch.num_conv_pos_embedding_groups)
    if kp % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    t = h.shape[1]
    frames = torch.arange(t)
    E = sd["layers_0.attention.rel_attn_embed.weight"]
    if drop == "table":
        E = torch.zeros_like(E)
    table = E[bucket(frames[None, :] - frames[:, None], arch.num_buckets,
                     arch.max_bucket_distance)].permute(2, 0, 1)
    states = [h]
    for i in range(arch.num_layers):
        n = f"layers_{i}"
        h = h + attention(_ln(h, sd, f"{n}.layer_norm", eps), sd, f"{n}.attention",
                          arch.num_heads, table, drop)
        ff = _lin(F.gelu(_lin(_ln(h, sd, f"{n}.final_layer_norm", eps), sd,
                              f"{n}.intermediate_dense")), sd, f"{n}.output_dense")
        h = h + ff
        states.append(h)
    states[-1] = _ln(h, sd, "encoder_layer_norm", eps)
    return states
