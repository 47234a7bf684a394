"""The maze models: port of ``adfmsl/models/mazes.py`` for the sinc family.

This slice ports ``MazeSpec``, ``MazeModel``'s sinc front end, trunk, pooling,
classifier and FMSL 'refine' head with the scores (adfmsl :95-273), and the
``SPECS`` of ``maze5`` / ``maze5_fmsl``. Other registry names raise and name
the ROADMAP slice that brings them.

Output contract (as adfmsl): dict with 'logits' (B, 2), 'scores' (B,) =
log-softmax[:, 1], 'features' (B, D) and, for FMSL models,
'prototype_similarity'. Canonical label polarity: bonafide=1, spoof=0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.config.base import ModelConfig
from adfmsl_torch.device import resolve_device
from adfmsl_torch.heads.fmsl import FMSLHead
from adfmsl_torch.models.blocks import ResStack, init_like_flax_
from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.ops.norm import batch_norm, bn_eval


@dataclass(frozen=True)
class MazeSpec:
    name: str
    frontend: str                                   # 'sinc' in this slice
    ref: str = ""                                   # reference file reproduced
    first_bn_act: Optional[str] = None              # 'selu' after the front end
    blocks: Tuple[Tuple[int, int, int], ...] = ()   # (cin, cout, stride)
    fc1: Optional[int] = 1024
    score: str = "log_softmax"


_SINC_BLOCKS = ((128, 128, 1), (128, 128, 2), (128, 128, 2), (128, 128, 2),
                (128, 256, 2))                       # maze4.py:192-210

SPECS: Dict[str, MazeSpec] = {
    "maze5": MazeSpec("maze5", "sinc", ref="maze5.py:178-264",
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    "maze5_fmsl": MazeSpec("maze5_fmsl", "sinc",
                           ref="maze5.py:178-264 + fmsl_advanced.py:103-359",
                           first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
}

# Registry names of adfmsl that later slices of the port bring (ROADMAP.md).
LATER_SLICES = {
    **{n: "slice 4 (RawNet main / main_fmsl, and the maze4 pair)"
       for n in ("main", "main_fmsl", "maze4", "maze4_fmsl")},
    **{n: "slice 5 (LFCC / log-mel front ends, LCNN and ResNet)"
       for n in ("lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel")},
    **{n: "slice 6 (the Wav2Vec2 family)"
       for b in ("maze2", "maze3", "maze6", "maze7", "maze8")
       for n in (b, f"{b}_fmsl")},
}


class MazeModel(nn.Module):
    """Eval-mode maze model on ``device`` (``None`` means ``cuda``; a missing
    card raises). Weights are initialised like adfmsl's (lecun_normal kernels,
    zero biases, xavier_uniform FMSL prototypes/weights, unit BN and
    temperature) from ``generator``; load trained or ported weights with
    ``load_state_dict``. Module names follow adfmsl's flax tree
    (models/port.py)."""

    def __init__(self, spec: MazeSpec, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if spec.frontend != "sinc":
            raise NotImplementedError(f"front end {spec.frontend!r} is not ported")
        self.spec, self.cfg = spec, cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        a = cfg.architecture
        self.sinc = SincConv(a.filts[0], a.first_conv, a.sample_rate,
                             formula=a.sinc_formula,
                             exact_fp32=cfg.dtype == "float32")
        if spec.first_bn_act:
            self.first_bn = batch_norm(a.filts[0])
        if a.block_semantics != "tpu":
            raise NotImplementedError(
                f"block_semantics {a.block_semantics!r}: the port has 'tpu' only "
                "(reference semantics come with ROADMAP slice 9)")
        self.trunk = ResStack(spec.blocks,
                              fused_eval=bool(cfg.extra.get("fused_eval_trunk", False)),
                              dtype=self.dtype)
        pooled_dim = spec.blocks[-1][1]
        fmsl = cfg.fmsl
        if fmsl is None:
            self.fc1 = nn.Linear(pooled_dim, spec.fc1)
            self.fc2 = nn.Linear(spec.fc1, a.nb_classes)
        elif fmsl.mode == "refine":
            fdim = spec.fc1 or a.nb_fc_node
            self.fc1 = nn.Linear(pooled_dim, fdim)
            self.fmsl = FMSLHead(fmsl, input_dim=fdim)
            self.fc2 = nn.Linear(fdim, a.nb_classes)
        else:
            raise NotImplementedError(
                f"FMSL mode {fmsl.mode!r} comes with a later slice (ROADMAP.md)")
        self.reset_parameters(generator)
        self.to(dev)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_(self, generator)
        self.sinc.reset_parameters()
        if hasattr(self, "fmsl"):
            self.fmsl.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, T) f32 waveform -> the output dict. Eval only in this slice."""
        if self.training:
            raise NotImplementedError("training comes with ROADMAP slice 2; "
                                      "call .eval()")
        h = self.sinc(x)                                     # (B, T', C) f32
        if self.spec.first_bn_act:
            # front-end glue at trunk width: bf16 in, BN in f32, bf16 out
            h = F.selu(bn_eval(h.to(self.dtype), self.first_bn, self.dtype))
        h = self.trunk(h)
        # mean over time with f32 accumulation, rounded to the trunk dtype
        pooled = h.float().mean(dim=1).to(h.dtype).float()
        out = {}
        if hasattr(self, "fmsl"):
            fout = self.fmsl(self.fc1(pooled))
            out["features"] = fout["embeddings"]
            out["prototype_similarity"] = fout["prototype_similarity"]
            logits = self.fc2(fout["embeddings"])
        else:
            feats = self.fc1(pooled)
            out["features"] = feats
            logits = self.fc2(feats)
        out["logits"] = logits
        out["scores"] = torch.log_softmax(logits, dim=-1)[:, 1]
        return out


def build_model(cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                seed: Optional[int] = 0) -> MazeModel:
    """Build a ported registry model on ``device`` (``None`` means ``cuda``),
    randomly initialised from ``seed``."""
    if cfg.name not in SPECS:
        later = LATER_SLICES.get(cfg.name)
        if later:
            raise NotImplementedError(f"model {cfg.name!r} is not ported yet: "
                                      f"it comes with ROADMAP {later}")
        raise KeyError(f"unknown model {cfg.name!r}; ported: {sorted(SPECS)}")
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return MazeModel(SPECS[cfg.name], cfg, device=device, generator=gen)
