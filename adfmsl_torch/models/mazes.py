"""The maze models: port of ``adfmsl/models/mazes.py`` for the sinc, RawNet
and (part of the) Wav2Vec2 families.

Ported: ``MazeSpec``, ``MazeModel``'s sinc front end and trunk, the RawNet
encoder branch (adfmsl :102-115), the Wav2Vec2 front end (:116-138, with
``wav2vec2.freeze`` as a stop-gradient) and the 1x1 ``proj`` conv after it
(:142-143), SpecAugment (:155-163), pooling, the classifier with its fc
dropout and maze3's ReLU after fc1 (:209), the FMSL head in the 'refine',
'replace' and 'integrated' modes, and both scores (adfmsl :95-273); the
``SPECS`` of ``main``, ``maze4``, ``maze5`` and their ``_fmsl`` twins,
``maze7`` / ``maze7_fmsl`` and ``maze3``, all in train and eval mode. ``build_model`` also builds adfmsl's extra families (``EXTRAS``:
``models/lcnn.py``, ``models/resnet.py``). Other registry names raise and
name the ROADMAP slice that brings them.

Output contract (as adfmsl): dict with 'logits' (B, 2), 'scores' (B,) =
log-softmax[:, 1] or the raw logit[:, 1] (``MazeSpec.score``), 'features'
(B, D), for FMSL models 'prototype_similarity', and 'loss' when an FMSL model
in mode 'replace' or 'integrated' is given labels. Canonical label polarity:
bonafide=1, spoof=0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.config.base import ModelConfig
from adfmsl_torch.device import resolve_device
from adfmsl_torch.heads.fmsl import FMSLHead
from adfmsl_torch.models.blocks import GRU, ResStack, conv_nhc, init_like_flax_
from adfmsl_torch.models.lcnn import LCNN, LCNN1D
from adfmsl_torch.models.rawnet import RawNetEncoder
from adfmsl_torch.models.resnet import ResNet18
from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.models.w2v2 import Wav2Vec2Encoder, arch_for
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.ops.specaugment import spec_augment


@dataclass(frozen=True)
class MazeSpec:
    name: str
    frontend: str                                   # 'sinc' | 'w2v2' | 'rawnet'
    ref: str = ""                                   # reference file reproduced
    proj_dim: Optional[int] = None                  # 1x1 conv after the front end
    first_bn_act: Optional[str] = None              # 'selu' | 'relu' after the front end
    blocks: Tuple[Tuple[int, int, int], ...] = ()   # (cin, cout, stride)
    fc1: Optional[int] = 1024
    fc1_act: Optional[str] = None                   # 'relu' between fc1 and dropout (maze3)
    score: str = "log_softmax"                      # 'log_softmax' | 'logit'
    fmsl_input_dim: int = 512                       # FMSL input, 'replace'/'integrated'


_SINC_BLOCKS = ((128, 128, 1), (128, 128, 2), (128, 128, 2), (128, 128, 2),
                (128, 256, 2))                       # maze4.py:192-210
# maze3.py:118-132: three blocks, each with its built-in stride-2 overlap pool
_W2V2_BLOCKS_MAZE3 = ((128, 128, 2), (128, 128, 2), (128, 256, 2))

_FMSL_REF = " + fmsl_advanced.py:103-359"

SPECS: Dict[str, MazeSpec] = {
    # fc1=None: the RawNet head is fc1_gru -> fc2 with nothing in between
    "main": MazeSpec("main", "rawnet", ref="01_Baseline_Models/main.py:182",
                     fc1=None),
    # 'replace': the FMSL head on fc1_gru's 1024-d output gives the logits,
    # scored raw (adfmsl mazes.py:325, :338)
    "main_fmsl": MazeSpec("main_fmsl", "rawnet",
                          ref="01_Baseline_Models/main.py:182" + _FMSL_REF,
                          fc1=None, score="logit", fmsl_input_dim=1024),
    "maze4": MazeSpec("maze4", "sinc", ref="maze4.py:165-247",
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # 'integrated' at the pooled trunk width, scored raw (adfmsl mazes.py:328).
    # adfmsl's 'fmsl_adaptive' block variant applies only under 'reference'
    # block semantics, which the port does not have yet.
    "maze4_fmsl": MazeSpec("maze4_fmsl", "sinc", ref="maze4.py:165-247" + _FMSL_REF,
                           first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024,
                           score="logit", fmsl_input_dim=256),
    "maze5": MazeSpec("maze5", "sinc", ref="maze5.py:178-264",
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    "maze5_fmsl": MazeSpec("maze5_fmsl", "sinc", ref="maze5.py:178-264" + _FMSL_REF,
                           first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # classifier Linear(256, 1024) -> ReLU -> Dropout -> Linear, scored raw
    # (maze3.py:137-143 with the :994 runtime config)
    "maze3": MazeSpec("maze3", "w2v2", ref="maze3.py:101-164", proj_dim=128,
                      blocks=_W2V2_BLOCKS_MAZE3, fc1=1024, fc1_act="relu",
                      score="logit"),
    "maze7": MazeSpec("maze7", "w2v2", ref="maze7.py:144-217", proj_dim=128,
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # 'integrated' at the pooled trunk width, scored raw (adfmsl mazes.py:328);
    # the 'fmsl_adaptive' block variant applies only under 'reference'
    # semantics, as for maze4_fmsl
    "maze7_fmsl": MazeSpec("maze7_fmsl", "w2v2", ref="maze7.py:144-217" + _FMSL_REF,
                           proj_dim=128, first_bn_act="selu", blocks=_SINC_BLOCKS,
                           fc1=1024, score="logit", fmsl_input_dim=256),
}

# adfmsl's extra model families (config/standardized.py:EXTRA_MODELS), each
# its own module: the LFCC / log-mel models.
EXTRAS = {"lcnn_lfcc": LCNN, "lcnn1d_lfcc": LCNN1D, "resnet18_logmel": ResNet18}

# Registry names of adfmsl that later slices of the port bring (ROADMAP.md).
LATER_SLICES = {n: "slice 6b (the rest of the Wav2Vec2 family)"
                for n in ("maze2", "maze2_fmsl", "maze3_fmsl", "maze6", "maze6_fmsl",
                          "maze8", "maze8_fmsl")}


class MazeModel(nn.Module):
    """Maze model on ``device`` (``None`` means ``cuda``; a missing card
    raises), built in eval mode; ``.train()`` switches it to training.
    Weights are initialised like adfmsl's (lecun_normal kernels, zero biases,
    xavier_uniform FMSL prototypes/weights, unit BN and temperature) from
    ``generator``; load trained or ported weights with
    ``load_state_dict``. Module names follow adfmsl's flax tree
    (models/port.py)."""

    def __init__(self, spec: MazeSpec, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.spec, self.cfg = spec, cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        a = cfg.architecture
        if spec.frontend == "rawnet":
            self.encoder = RawNetEncoder(
                sinc_channels=a.filts[0], sinc_kernel=a.first_conv,
                feature_dim=a.nb_fc_node, gru_layers=a.nb_gru_layer,
                sinc_formula=a.sinc_formula,
                fused_eval_frontend=bool(cfg.extra.get("fused_eval_frontend", False)),
                fused_train_frontend=bool(cfg.extra.get("fused_train_frontend", False)),
                fused_eval_trunk=bool(cfg.extra.get("fused_eval_trunk", False)),
                dtype=self.dtype)
            pooled_dim = a.nb_fc_node
        elif spec.frontend in ("sinc", "w2v2"):
            if spec.frontend == "sinc":
                self.sinc = SincConv(a.filts[0], a.first_conv, a.sample_rate,
                                     formula=a.sinc_formula,
                                     exact_fp32=cfg.dtype == "float32")
                feat_dim = a.filts[0]
            else:
                w = cfg.wav2vec2
                if w.remat_layers or w.remat_extractor:
                    raise NotImplementedError(
                        "wav2vec2.remat_layers / remat_extractor (activation "
                        "checkpointing) come with ROADMAP slice 6c")
                self.wav2vec2 = Wav2Vec2Encoder(arch_for(w), dtype=self.dtype)
                feat_dim = self.wav2vec2.arch.hidden_size
            if spec.proj_dim:
                self.proj = nn.Conv1d(feat_dim, spec.proj_dim, 1)
                feat_dim = spec.proj_dim
            if spec.first_bn_act:
                self.first_bn = batch_norm(feat_dim)
            if a.block_semantics != "tpu":
                raise NotImplementedError(
                    f"block_semantics {a.block_semantics!r}: the port has 'tpu' only "
                    "(reference semantics come with ROADMAP slice 9)")
            self.trunk = ResStack(spec.blocks, a.dropout_rate,
                                  fused_eval=bool(cfg.extra.get("fused_eval_trunk", False)),
                                  dtype=self.dtype)
            pooled_dim = spec.blocks[-1][1]
        else:
            raise NotImplementedError(f"front end {spec.frontend!r} is not ported")
        fmsl = cfg.fmsl
        if fmsl is None:
            if spec.fc1:
                self.fc1 = nn.Linear(pooled_dim, spec.fc1)
            self.fc2 = nn.Linear(spec.fc1 or pooled_dim, a.nb_classes)
        elif fmsl.mode == "refine":
            fdim = spec.fc1 or a.nb_fc_node
            self.fc1 = nn.Linear(pooled_dim, fdim)
            self.fmsl = FMSLHead(fmsl, input_dim=fdim)
            self.fc2 = nn.Linear(fdim, a.nb_classes)
        elif fmsl.mode in ("replace", "integrated"):
            # the pooled features go straight into the FMSL head, whose logits
            # are the model's (adfmsl :254-267); the modes differ in training
            if pooled_dim != spec.fmsl_input_dim:
                raise ValueError(f"{spec.name}: pooled dim {pooled_dim} != FMSL "
                                 f"input dim {spec.fmsl_input_dim}")
            self.fmsl = FMSLHead(fmsl, input_dim=pooled_dim)
        else:
            raise NotImplementedError(
                f"FMSL mode {fmsl.mode!r} comes with a later slice (ROADMAP.md)")
        self.reset_parameters(generator)
        self.to(dev)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_(self, generator)
        for m in self.modules():
            if isinstance(m, SincConv):
                m.reset_parameters()
            elif isinstance(m, (GRU, FMSLHead)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rngs: Optional[Mapping[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """(B, T) f32 waveform -> the output dict. ``labels`` (B,) and ``mask``
        (B,) feed the FMSL head's losses. In train mode ``rngs`` holds the
        generators of the 'dropout', 'specaugment' and 'lsa' streams that the
        configuration draws from (adfmsl's rng collections)."""
        train = self.training
        rngs = rngs or {}
        if self.spec.frontend == "rawnet":
            pooled = self.encoder(x)                         # (B, D) f32
        else:
            if self.spec.frontend == "sinc":
                h = self.sinc(x)                             # (B, T', C) f32
            elif self.cfg.wav2vec2.freeze:                   # a stop-gradient
                with torch.no_grad():
                    h = self.wav2vec2(x)                     # (B, T', H)
            else:
                h = self.wav2vec2(x)
            if self.spec.proj_dim:
                h = conv_nhc(h, self.proj, self.dtype)
            if self.spec.first_bn_act:
                # front-end glue at trunk width: bf16 in, BN in f32, bf16 out
                act = F.selu if self.spec.first_bn_act == "selu" else F.relu
                h = act(bn_forward(h.to(self.dtype), self.first_bn, self.dtype, train))
            sa = self.cfg.spec_augment
            if sa.enabled and train:
                # (B, T, C): C is the frequency / channel axis
                h = spec_augment(h, rngs["specaugment"], sa.freq_mask_param,
                                 sa.time_mask_param, sa.n_freq_masks, sa.n_time_masks,
                                 sa.semantics, channels_last=True)
            h = self.trunk(h, rngs.get("dropout"))
            # mean over time with f32 accumulation, rounded to the trunk dtype
            pooled = h.float().mean(dim=1).to(h.dtype).float()
        fc_drop = self.cfg.architecture.fc_dropout
        out = {}
        if hasattr(self, "fmsl"):
            refine = hasattr(self, "fc1")
            if refine:
                h2 = dropout(self.fc1(pooled), fc_drop, rngs.get("dropout"), train)
                fout = self.fmsl(h2, labels=labels, mask=mask, rngs=rngs)
                logits = self.fc2(fout["embeddings"])
            else:
                fout = self.fmsl(pooled, labels=labels, mask=mask, rngs=rngs)
                logits = fout["logits"]
                if labels is not None:
                    out["loss"] = (fout["loss"] if self.cfg.fmsl.mode == "integrated"
                                   else fout["ce_loss"])
            out["features"] = fout["embeddings"]
            out["prototype_similarity"] = fout["prototype_similarity"]
        else:
            feats = pooled
            if hasattr(self, "fc1"):
                feats = self.fc1(pooled)
                if self.spec.fc1_act == "relu":              # maze3's classifier
                    feats = torch.relu(feats)
                feats = dropout(feats, fc_drop, rngs.get("dropout"), train)
            out["features"] = feats
            logits = self.fc2(feats)
        out["logits"] = logits
        if self.spec.score == "log_softmax":
            out["scores"] = torch.log_softmax(logits, dim=-1)[:, 1]
        else:
            out["scores"] = logits[:, 1]
        return out


def build_model(cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                seed: Optional[int] = 0) -> nn.Module:
    """Build a ported registry model on ``device`` (``None`` means ``cuda``),
    randomly initialised from ``seed``: a ``MazeModel`` for the ``SPECS``
    names, the model's own class for the ``EXTRAS``."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    if cfg.name in EXTRAS:
        return EXTRAS[cfg.name](cfg, device=device, generator=gen)
    if cfg.name not in SPECS:
        later = LATER_SLICES.get(cfg.name)
        if later:
            raise NotImplementedError(f"model {cfg.name!r} is not ported yet: "
                                      f"it comes with ROADMAP {later}")
        raise KeyError(f"unknown model {cfg.name!r}; ported: "
                       f"{sorted([*SPECS, *EXTRAS])}")
    return MazeModel(SPECS[cfg.name], cfg, device=device, generator=gen)
