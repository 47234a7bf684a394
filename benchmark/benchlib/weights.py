"""Weights drawn from the seed, on the card, in a few large calls.

``plan`` lists the program's state-dict names with their shapes and how each
is drawn; ``draw`` makes the tensors from ``--seed`` with one normal and one
uniform draw over all of them, so the same seed gives the same weights in the
program and, drawn again after the window, in the reference:

- a conv's or linear's weight: normal / sqrt(fan in); its bias 0.1 of that;
- a norm's scale 1 + 0.1 N and bias 0.1 N;
- BatchNorm running statistics from ``calibrate``: the reference's float32
  forward over a few of the seed's utterances sets each BN's running mean to
  its input's mean + 0.1 N standard deviations and its variance to the
  input's times 0.5 + U. A trained model's statistics fit its activations;
  drawn blind they would not, and the head's BNs would pass on mostly their
  offsets. The jitter keeps them off the batch's own, so every BN of the
  eval path, K1's folded ones included, normalises with statistics of its
  own;
- leaves outside those modules by the configuration's ``init`` table:
  'normal' (N), 'one', and 'mel_low' / 'mel_band' (the SincNet mel-spaced
  edges, each times 1 + 0.02 N).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from reference import ops

Entry = Tuple[str, Tuple[int, ...], str, int]     # name, shape, kind, fan in

_NORMS = (nn.BatchNorm1d, nn.LayerNorm, nn.GroupNorm)


def plan(model: nn.Module, cfg: dict) -> List[Entry]:
    """(name, shape, kind, fan in) of every state-dict entry of ``model``."""
    owner = {}
    for mname, m in model.named_modules():
        for leaf, _ in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            owner[f"{mname}.{leaf}" if mname else leaf] = (m, leaf)
    table = cfg.get("init", {})
    out = []
    for name, t in model.state_dict().items():
        m, leaf = owner[name]
        fan = 0
        if name in table:
            kind = table[name]
        elif leaf == "num_batches_tracked":
            kind = "count"
        elif leaf in ("running_mean", "running_var"):
            kind = leaf
        elif isinstance(m, _NORMS):
            kind = "norm_" + leaf
        elif isinstance(m, (nn.Conv1d, nn.Linear)):
            kind = leaf
            fan = m.weight[0].numel()
        else:
            raise KeyError(f"{name}: no rule draws it; name it in the configuration's "
                           "'init' table")
        out.append((name, tuple(t.shape), kind, fan))
    return out


def draw(entries: List[Entry], seed: int, device, cfg: dict) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s, _, _ in entries]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    sd, off = {}, 0
    for (name, shape, kind, fan), n in zip(entries, sizes):
        z, u = normal[off:off + n].view(shape), uniform[off:off + n].view(shape)
        off += n
        if kind == "weight":
            sd[name] = z / math.sqrt(fan)
        elif kind == "bias":
            sd[name] = 0.1 * z / math.sqrt(fan)
        elif kind == "norm_weight":
            sd[name] = 1.0 + 0.1 * z
        elif kind == "norm_bias":
            sd[name] = 0.1 * z
        elif kind == "running_mean":
            sd[name] = 0.1 * z
        elif kind == "running_var":
            sd[name] = 0.5 + u
        elif kind == "count":
            sd[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "normal":
            sd[name] = z.clone()
        elif kind == "one":
            sd[name] = torch.ones(shape, device=device)
        elif kind in ("mel_low", "mel_band"):
            low, band = ops.mel_edges(shape[0], cfg["sample_rate"], cfg["sinc_min_low_hz"],
                                      cfg["sinc_min_band_hz"])
            base = torch.from_numpy(low if kind == "mel_low" else band).to(device)
            sd[name] = base * (1.0 + 0.02 * z)
        else:
            raise KeyError(f"{name}: unknown draw {kind!r}")
    return sd


def calibrate(sd: Dict[str, torch.Tensor], ref, cfg: dict, x: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Set ``sd``'s BatchNorm running statistics from the reference's float32
    forward over ``x`` (see the module's note); returns them."""
    sd[ops.CALIBRATE] = True
    try:
        with torch.no_grad(), ops.no_tf32():
            ref.scores(sd, x, cfg, ops.Prec("f32"))
    finally:
        del sd[ops.CALIBRATE]
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
