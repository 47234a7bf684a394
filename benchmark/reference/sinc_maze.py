"""Reference of the sinc SE-ResNet models (the thesis's maze5 family:
``maze5.py:178-264``, with ``fmsl_advanced.py:103-359``'s refine head).

waveform -> SincNet filterbank conv (C filters, kernel K, VALID) -> BN -> act
-> the 'tpu' SE-residual blocks (``ops.resblock``) -> mean over time -> fc1
-> [FMSL refine head: Linear, BN, ReLU, L2 normalisation] -> fc2 -> score.
The front end's activation, the trunk and the pooled features are the
configuration's bfloat16 tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import ops


def filters(sd, cfg):
    return ops.sinc_filters(sd["sinc.low_hz"], sd["sinc.band_hz"], cfg["sinc_kernel"],
                            cfg["sample_rate"], cfg["sinc_min_low_hz"],
                            cfg["sinc_min_band_hz"])


def _act(name):
    return F.selu if name == "selu" else torch.relu


def pooled(sd, x, cfg, prec, train=False, dropout=None, specaugment=None):
    """(B, T) waveform -> (B, D) time-mean of the trunk's output."""
    h = F.conv1d(x[:, None, :], filters(sd, cfg)[:, None, :])
    bn = ops.bn_train if train else ops.bn_eval
    h = prec.q(_act(cfg["first_bn_act"])(bn(h, sd, "first_bn")), True)
    if specaugment is not None:
        h = specaugment(h)
    for i, (_, _, stride) in enumerate(ops.blocks_of(cfg)):
        h = ops.resblock(h, sd, f"trunk.block{i}", stride, i == 0, prec, train, dropout)
    return prec.q(h.mean(2), True)


def head(sd, p, cfg, train=False, dropout=None, dropout_fc=None):
    """Pooled features -> logits (and the FMSL embeddings)."""
    h = p @ sd["fc1.weight"].t() + sd["fc1.bias"]
    if train and dropout_fc is not None:
        h = dropout_fc(h)
    fm = cfg.get("fmsl")
    if fm:
        bn = ops.bn_train if train else ops.bn_eval
        h = torch.relu(bn(h @ sd["fmsl.proj.weight"].t() + sd["fmsl.proj.bias"], sd,
                          "fmsl.proj_bn"))
        if train and dropout is not None:
            h = dropout(h)
        h = ops.l2_normalize(h)
    return h @ sd["fc2.weight"].t() + sd["fc2.bias"]


def scores(sd, x, cfg, prec):
    return ops.score_of(head(sd, pooled(sd, x, cfg, prec), cfg), cfg["score"])


def forward_flops(cfg, cut: int) -> float:
    """Products of one utterance's forward: the filterbank conv, the trunk,
    fc1, the FMSL projection and fc2."""
    c, k = cfg["sinc_filters"], cfg["sinc_kernel"]
    t = cut - k + 1
    total = ops.conv_flops(t, 1, c, k)
    trunk, _ = ops.trunk_flops(ops.blocks_of(cfg), t)
    d = cfg["blocks"][-1][1]
    total += trunk + ops.linear_flops(1, d, cfg["fc1"]) + ops.linear_flops(1, cfg["fc1"], 2)
    if cfg.get("fmsl"):
        total += ops.linear_flops(1, cfg["fc1"], cfg["fc1"])
    return total


def k1_calls(cfg, cut: int) -> list:
    return ops.k1_calls(ops.blocks_of(cfg), cut - cfg["sinc_kernel"] + 1)


def spec_mask(gen, b: int, size: int, param: int, n_masks: int, device):
    """SpecAugment's hand-rolled masks of the reference scripts
    (``maze4_fmsl_standardized.py:193-214``), drawn per row: start ~ U{0..param-1},
    end = start + floor(u (size - start)), u ~ U[0, 1); zeros [start, end).
    Returns the (B, size) {0, 1} product of ``n_masks`` masks."""
    keep = torch.ones((b, size), device=device)
    idx = torch.arange(size, device=device)[None, :]
    for _ in range(n_masks):
        start = torch.randint(0, max(param, 1), (b, 1), generator=gen, device=device)
        u = torch.rand((b, 1), generator=gen, device=device)
        end = start + torch.floor(u * (size - start)).long()
        keep = keep * ((idx < start) | (idx >= end)).float()
    return keep


def train_logits(sd, x, cfg, prec, gens):
    """Train-mode logits: batch statistics in every BN, SpecAugment after the
    front end's activation (frequency masks, then time masks, from
    ``gens['specaugment']``), and dropout from ``gens['dropout']`` in the order
    the layers run: each block after its second BN (drawn over (B, T, C)),
    then after fc1, then in the FMSL projection."""
    dev = x.device
    sa = cfg["spec_augment"]

    def block_dropout(h):
        if cfg["dropout_rate"] == 0:
            return h
        b, c, t = h.shape
        return h * ops.dropout_mask((b, t, c), cfg["dropout_rate"], gens["dropout"],
                                    dev).transpose(1, 2)

    def flat_dropout(rate):
        if rate == 0:
            return lambda h: h
        return lambda h: h * ops.dropout_mask(h.shape, rate, gens["dropout"], dev)

    def specaugment(h):
        b, c, t = h.shape
        f = spec_mask(gens["specaugment"], b, c, sa["freq_mask_param"], sa["n_freq_masks"], dev)
        tm = spec_mask(gens["specaugment"], b, t, sa["time_mask_param"], sa["n_time_masks"],
                       dev)
        return h * f[:, :, None] * tm[:, None, :]

    p = pooled(sd, x, cfg, prec, train=True, dropout=block_dropout, specaugment=specaugment)
    fm = cfg.get("fmsl") or {}
    return head(sd, p, cfg, train=True, dropout=flat_dropout(fm.get("proj_dropout", 0.0)),
                dropout_fc=flat_dropout(cfg["fc_dropout"]))


def loss(logits, labels, cfg):
    """Class-weighted cross entropy over the sum of the target weights."""
    w = torch.as_tensor(cfg["train"]["class_weights"], device=logits.device)[labels]
    ce = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    return (ce * w).sum() / w.sum()


def train_flops(cfg, cut: int) -> float:
    """One utterance's train step: the forward, and the backward's input and
    weight products (twice the forward's), less the filterbank conv's input
    gradient, which nothing asks for."""
    c, k = cfg["sinc_filters"], cfg["sinc_kernel"]
    return 3 * forward_flops(cfg, cut) - ops.conv_flops(cut - k + 1, 1, c, k)
