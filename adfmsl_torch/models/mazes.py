"""The maze models: port of ``adfmsl/models/mazes.py`` for every registry name.

Ported: ``MazeSpec`` and ``MazeModel`` (adfmsl :95-273), in train and eval
mode: the sinc front end, the RawNet encoder branch (:102-115), the Wav2Vec2
front end (:116-138, with ``wav2vec2.freeze`` as a stop-gradient, the
encoder's ``remat_layers`` / ``remat_extractor`` checkpointing and maze6's
``fusion_layers`` taps concatenated), the 1x1 ``proj`` conv (:142-143), the
front-end BN + act, SpecAugment (:155-163), maze8's ``ConvFMSLLayer``
(:165-166), the SE-ResBlock trunk, the transformer (:178-194: maze2's and
maze6's plain encoder behind a BatchNorm, maze3_fmsl's projected stack),
mean or attentive-stats pooling (:196-199), the classifier with its fc
dropout and maze3's ReLU after fc1 (:209), the FMSL head in the 'refine',
'replace', 'integrated' and 'fallback' modes, and both scores; the ``SPECS``
of all 16 registry names (:280-386). ``build_model`` dispatches through
``model_registry``, which also holds adfmsl's extra families (``EXTRAS``:
``models/lcnn.py``, ``models/resnet.py``).
Under ``architecture.block_semantics='reference'`` (the reference checkpoints'
semantics, ``models/port.py:reference_parity_experiment``) the trunk's blocks
take ``MazeSpec.block_variant`` where the spec names one (adfmsl :169-171):
'maze2', 'maze3', 'fmsl_plain', 'fmsl_se' or 'fmsl_adaptive'
(``models/blocks.py:ResBlockSE``).

Output contract (as adfmsl): dict with 'logits' (B, 2), 'scores' (B,) =
log-softmax[:, 1] or the raw logit[:, 1] (``MazeSpec.score``), 'features'
(B, D), for FMSL models 'prototype_similarity', and 'loss' when an FMSL model
in mode 'replace' or 'integrated' is given labels. Canonical label polarity:
bonafide=1, spoof=0.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.config.base import ModelConfig
from adfmsl_torch.device import resolve_device
from adfmsl_torch.heads.fmsl import FMSLHead
from adfmsl_torch.models.blocks import (GRU, AttentiveStatsPooling, ConvFMSLLayer,
                                       ConvNHC, PlainTransformerEncoder, ResStack,
                                       TransformerEncoderStack, init_like_flax_)
from adfmsl_torch.models.lcnn import LCNN, LCNN1D
from adfmsl_torch.models.rawnet import RawNetEncoder
from adfmsl_torch.models.resnet import ResNet18
from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.models.w2v2 import Wav2Vec2Encoder, arch_for
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.ops.specaugment import spec_augment
from adfmsl_torch.utils.profiling import annotate
from adfmsl_torch.utils.registry import Registry


@dataclass(frozen=True)
class MazeSpec:
    name: str
    frontend: str                                   # 'sinc' | 'w2v2' | 'rawnet'
    ref: str = ""                                   # reference file reproduced
    proj_dim: Optional[int] = None                  # 1x1 conv after the front end
    first_bn_act: Optional[str] = None              # 'selu' | 'relu' after the front end
    blocks: Tuple[Tuple[int, int, int], ...] = ()   # (cin, cout, stride)
    transformer: Optional[Tuple[int, int, int, int]] = None   # (d, heads, layers, ff)
    # True: the torch-style encoder at the trunk width behind a BatchNorm
    # (maze2 / maze6); False: the in-proj + learned-pos-emb stack (maze3_fmsl)
    transformer_plain: bool = False
    conv_fmsl: bool = False                         # maze8's conv FMSL layer
    pooling: str = "avg"                            # 'avg' | 'asp'
    fc1: Optional[int] = 1024
    fc1_act: Optional[str] = None                   # 'relu' between fc1 and dropout (maze3)
    score: str = "log_softmax"                      # 'log_softmax' | 'logit'
    fmsl_input_dim: int = 512                       # FMSL input, 'replace'/'integrated'
    fusion_layers: Optional[Tuple[int, ...]] = None     # maze6's encoder taps
    # the trunk's block semantics when architecture.block_semantics is
    # 'reference' (None: 'reference' itself); unused under 'tpu', as in adfmsl
    block_variant: Optional[str] = None
    use_se: bool = True                             # maze3_fmsl's blocks have no SE
    asp_std: bool = True                # False: maze6_fmsl's ASP takes the raw variance


_SINC_BLOCKS = ((128, 128, 1), (128, 128, 2), (128, 128, 2), (128, 128, 2),
                (128, 256, 2))                       # maze4.py:192-210
# maze2.py:143-155: block0 (w2v2_dim -> 128) then five strided blocks ending 256 -> 256
_W2V2_BLOCKS_MAZE2 = ((768, 128, 1), (128, 128, 2), (128, 128, 2), (128, 128, 2),
                      (128, 256, 2), (256, 256, 2))
# maze6.py:213-231: block0 (projected 1024 -> 128) + the maze4-style strided walk
_W2V2_BLOCKS_MAZE6 = ((1024, 128, 1), (128, 128, 2), (128, 128, 2), (128, 128, 2),
                      (128, 256, 2))
# maze3.py:118-132: three blocks, each with its built-in stride-2 overlap pool
_W2V2_BLOCKS_MAZE3 = ((128, 128, 2), (128, 128, 2), (128, 256, 2))
_MAZE6_TAPS = (0, 6, 12, 18, 24)

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
    "maze2": MazeSpec("maze2", "w2v2", ref="maze2.py:119-193",
                      blocks=_W2V2_BLOCKS_MAZE2, transformer=(256, 8, 6, 2048),
                      transformer_plain=True, first_bn_act="selu", fc1=1024,
                      block_variant="maze2"),
    # the FMSL file's own smaller trunk, FMSL at the pooled trunk width
    # (maze2_fmsl_standardized.py:394-487, adfmsl mazes.py:359-371)
    "maze2_fmsl": MazeSpec("maze2_fmsl", "w2v2", ref="maze2_fmsl_standardized.py:394-487",
                           proj_dim=128, first_bn_act="selu",
                           blocks=((128, 128, 1), (128, 128, 2), (128, 256, 1)),
                           fc1=1024, score="logit", fmsl_input_dim=256,
                           block_variant="fmsl_se"),
    # classifier Linear(256, 1024) -> ReLU -> Dropout -> Linear, scored raw
    # (maze3.py:137-143 with the :994 runtime config)
    "maze3": MazeSpec("maze3", "w2v2", ref="maze3.py:101-164", proj_dim=128,
                      blocks=_W2V2_BLOCKS_MAZE3, fc1=1024, fc1_act="relu",
                      score="logit", block_variant="maze3"),
    # SE-free blocks and the in-proj / pos-emb stack at d 512 (adfmsl :372-378)
    "maze3_fmsl": MazeSpec("maze3_fmsl", "w2v2", ref="maze3_fmsl_standardized.py:139-256",
                           proj_dim=128, blocks=((128, 128, 1), (128, 128, 1), (128, 256, 1)),
                           transformer=(512, 8, 6, 2048), fc1=256, score="logit",
                           fmsl_input_dim=256, block_variant="fmsl_plain", use_se=False),
    "maze4": MazeSpec("maze4", "sinc", ref="maze4.py:165-247",
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # 'integrated' at the pooled trunk width, scored raw (adfmsl mazes.py:328)
    "maze4_fmsl": MazeSpec("maze4_fmsl", "sinc", ref="maze4.py:165-247" + _FMSL_REF,
                           first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024,
                           score="logit", fmsl_input_dim=256,
                           block_variant="fmsl_adaptive"),
    "maze5": MazeSpec("maze5", "sinc", ref="maze5.py:178-264",
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    "maze5_fmsl": MazeSpec("maze5_fmsl", "sinc", ref="maze5.py:178-264" + _FMSL_REF,
                           first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # wav2vec2-large, five taps fused by the 1x1 proj, ASP, raw logit score
    "maze6": MazeSpec("maze6", "w2v2", ref="maze6.py:182-267", proj_dim=1024,
                      first_bn_act="relu", blocks=_W2V2_BLOCKS_MAZE6,
                      transformer=(256, 8, 4, 2048), transformer_plain=True,
                      pooling="asp", fc1=1024, score="logit", fusion_layers=_MAZE6_TAPS),
    # the FMSL file's own trunk; fc1 + ReLU + fc2 is the fallback classifier,
    # the checkpoint's live head in mode 'fallback' (adfmsl :379-386)
    "maze6_fmsl": MazeSpec("maze6_fmsl", "w2v2", ref="maze6_fmsl_standardized.py:213-382",
                           proj_dim=128, first_bn_act="selu",
                           blocks=((128, 128, 1), (128, 128, 2), (128, 256, 2)),
                           pooling="asp", fc1=1024, fc1_act="relu", score="logit",
                           fmsl_input_dim=512, fusion_layers=_MAZE6_TAPS,
                           block_variant="fmsl_plain", asp_std=False),
    "maze7": MazeSpec("maze7", "w2v2", ref="maze7.py:144-217", proj_dim=128,
                      first_bn_act="selu", blocks=_SINC_BLOCKS, fc1=1024),
    # 'integrated' at the pooled trunk width, scored raw (adfmsl mazes.py:328)
    "maze7_fmsl": MazeSpec("maze7_fmsl", "w2v2", ref="maze7.py:144-217" + _FMSL_REF,
                           proj_dim=128, first_bn_act="selu", blocks=_SINC_BLOCKS,
                           fc1=1024, score="logit", fmsl_input_dim=256,
                           block_variant="fmsl_adaptive"),
    "maze8": MazeSpec("maze8", "w2v2", ref="maze8.py:193-277", proj_dim=128,
                      first_bn_act="selu", blocks=_SINC_BLOCKS, conv_fmsl=True, fc1=1024),
    # the derived twin drops the conv FMSL layer; 'replace', scored raw
    "maze8_fmsl": MazeSpec("maze8_fmsl", "w2v2", ref="maze8.py:193-277" + _FMSL_REF,
                           proj_dim=128, first_bn_act="selu", blocks=_SINC_BLOCKS,
                           fc1=1024, score="logit", fmsl_input_dim=256,
                           block_variant="fmsl_adaptive"),
}

# adfmsl's extra model families (config/standardized.py:EXTRA_MODELS), each
# its own module: the LFCC / log-mel models.
EXTRAS = {"lcnn_lfcc": LCNN, "lcnn1d_lfcc": LCNN1D, "resnet18_logmel": ResNet18}


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
                self.wav2vec2 = Wav2Vec2Encoder(arch_for(w), dtype=self.dtype,
                                                remat_layers=w.remat_layers,
                                                remat_extractor=w.remat_extractor)
                feat_dim = self.wav2vec2.arch.hidden_size * len(spec.fusion_layers or (0,))
            if spec.proj_dim:
                self.proj = ConvNHC(feat_dim, spec.proj_dim, 1)
                feat_dim = spec.proj_dim
            if spec.first_bn_act:
                self.first_bn = batch_norm(feat_dim)
            if spec.conv_fmsl:
                self.conv_fmsl = ConvFMSLLayer(feat_dim)
            semantics = a.block_semantics
            if semantics == "reference" and spec.block_variant:
                semantics = spec.block_variant
            # block0 takes the front end's real width, as flax infers it (the
            # 'tiny' encoder feeds maze2's 768-wide block0 64 channels)
            blocks = ((feat_dim,) + tuple(spec.blocks[0][1:]),) + tuple(spec.blocks[1:])
            self.trunk = ResStack(blocks, a.dropout_rate, use_se=spec.use_se,
                                  semantics=semantics, fused_eval=bool(cfg.extra.get("fused_eval_trunk", False)),
                                  dtype=self.dtype)
            trunk_dim = spec.blocks[-1][1]
            if spec.transformer:
                d, heads, layers, ff = spec.transformer
                if spec.transformer_plain:
                    self.bn_before_transformer = batch_norm(trunk_dim)
                    self.transformer = PlainTransformerEncoder(
                        d, heads, layers, ff, a.transformer_dropout, self.dtype)
                else:
                    self.transformer = TransformerEncoderStack(
                        trunk_dim, d, heads, layers, ff, out_dim=trunk_dim,
                        dropout_rate=a.transformer_dropout, dtype=self.dtype)
            pooled_dim = trunk_dim
            if spec.pooling == "asp":
                self.asp = AttentiveStatsPooling(trunk_dim, use_std=spec.asp_std)
                pooled_dim = 2 * trunk_dim
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
        elif fmsl.mode in ("replace", "integrated", "fallback"):
            # the pooled features go straight into the FMSL head (adfmsl
            # :230-267); its logits are the model's, except in 'fallback' (the
            # literal maze6_fmsl path for ported checkpoints), where fc1 /
            # ReLU / dropout / fc2 on the pooled features give them
            if pooled_dim != spec.fmsl_input_dim:
                raise ValueError(f"{spec.name}: pooled dim {pooled_dim} != FMSL "
                                 f"input dim {spec.fmsl_input_dim}")
            self.fmsl = FMSLHead(fmsl, input_dim=pooled_dim)
            if fmsl.mode == "fallback":
                self.fc1 = nn.Linear(pooled_dim, spec.fc1)
                self.fc2 = nn.Linear(spec.fc1, a.nb_classes)
        else:
            raise ValueError(f"unknown FMSL mode {fmsl.mode!r}")
        self.reset_parameters(generator)
        self.to(dev)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_(self, generator)
        for m in self.modules():
            if isinstance(m, SincConv):
                m.reset_parameters()
            elif isinstance(m, (GRU, FMSLHead, TransformerEncoderStack)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rngs: Optional[Mapping[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """(B, T) f32 waveform -> the output dict. ``labels`` (B,) and ``mask``
        (B,) feed the FMSL head's losses. In train mode ``rngs`` holds the
        generators of the 'dropout', 'specaugment' and 'lsa' streams that the
        configuration draws from (adfmsl's rng collections)."""
        rngs = rngs or {}
        rawnet = self.spec.frontend == "rawnet"
        with annotate("stage.model.frontend"):
            h = self.encoder(x) if rawnet else self._frontend(x, rngs)
        if not rawnet:
            with annotate("stage.model.trunk"):
                h = self.trunk(h, rngs.get("dropout"))
        with annotate("stage.model.head"):
            pooled = h if rawnet else self._pool(h, rngs)
            return self._head(pooled, labels, mask, rngs)

    def _frontend(self, x: torch.Tensor, rngs: Mapping[str, torch.Generator]
                  ) -> torch.Tensor:
        """The waveform to the trunk's input (B, T, C)."""
        train, spec = self.training, self.spec
        if spec.frontend == "sinc":
            h = self.sinc(x)                                 # (B, T', C) f32
        else:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.cfg.wav2vec2.freeze):
                h = self._w2v2_features(x)                   # a stop-gradient if frozen
        if spec.proj_dim:
            h = self.proj(h, self.dtype)
        if spec.first_bn_act:
            # front-end glue at trunk width: bf16 in, BN in f32, bf16 out
            act = F.selu if spec.first_bn_act == "selu" else F.relu
            h = act(bn_forward(h.to(self.dtype), self.first_bn, self.dtype, train))
        sa = self.cfg.spec_augment
        if sa.enabled and train:
            # (B, T, C): C is the frequency / channel axis
            h = spec_augment(h, rngs["specaugment"], sa.freq_mask_param,
                             sa.time_mask_param, sa.n_freq_masks, sa.n_time_masks,
                             sa.semantics, channels_last=True)
        if spec.conv_fmsl:
            h = self.conv_fmsl(h, rngs.get("dropout"))       # f32 out
        return h

    def _pool(self, h: torch.Tensor, rngs: Mapping[str, torch.Generator]) -> torch.Tensor:
        """The trunk's output to the pooled (B, D) f32: the transformer, pooling."""
        spec = self.spec
        if spec.transformer:
            if spec.transformer_plain:                       # its BN has no dtype: f32 out
                h = bn_forward(h, self.bn_before_transformer, torch.float32, self.training)
            h = self.transformer(h, rngs.get("dropout"))
        if spec.pooling == "asp":
            return self.asp(h)                               # f32
        # mean over time with f32 accumulation, rounded to h's dtype
        return h.float().mean(dim=1).to(h.dtype).float()

    def _head(self, pooled: torch.Tensor, labels: Optional[torch.Tensor],
              mask: Optional[torch.Tensor], rngs: Mapping[str, torch.Generator]
              ) -> Dict[str, torch.Tensor]:
        """The pooled features to the output dict: fc1, the FMSL head, fc2."""
        train = self.training
        fc_drop = self.cfg.architecture.fc_dropout
        out = {}
        mode = self.cfg.fmsl.mode if self.cfg.fmsl is not None else None
        if mode is None:
            feats = pooled
            if hasattr(self, "fc1"):
                feats = self.fc1(pooled)
                if self.spec.fc1_act == "relu":              # maze3's classifier
                    feats = torch.relu(feats)
                feats = dropout(feats, fc_drop, rngs.get("dropout"), train)
            out["features"] = feats
            logits = self.fc2(feats)
        else:
            if mode == "refine":
                h2 = dropout(self.fc1(pooled), fc_drop, rngs.get("dropout"), train)
                fout = self.fmsl(h2, labels=labels, mask=mask, rngs=rngs)
                logits = self.fc2(fout["embeddings"])
            else:
                fout = self.fmsl(pooled, labels=labels, mask=mask, rngs=rngs)
                if mode == "fallback":
                    h2 = dropout(torch.relu(self.fc1(pooled)), fc_drop,
                                 rngs.get("dropout"), train)
                    logits = self.fc2(h2)
                else:
                    logits = fout["logits"]
                    if labels is not None:
                        out["loss"] = (fout["loss"] if mode == "integrated"
                                       else fout["ce_loss"])
            out["features"] = fout["embeddings"]
            out["prototype_similarity"] = fout["prototype_similarity"]
        out["logits"] = logits
        if self.spec.score == "log_softmax":
            out["scores"] = torch.log_softmax(logits, dim=-1)[:, 1]
        else:
            out["scores"] = logits[:, 1]
        return out


    def _w2v2_features(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's last hidden state, or with ``fusion_layers`` its
        taps (index clamped to the last layer) concatenated on channels."""
        taps = self.spec.fusion_layers
        if not taps:
            return self.wav2vec2(x)
        _, hs = self.wav2vec2(x, output_hidden_states=True)
        return torch.cat([hs[min(i, len(hs) - 1)] for i in taps], dim=-1)


# every registry name -> its factory (cfg, device=, generator=), as adfmsl's
# model_registry (models/mazes.py:45, :389-394)
model_registry = Registry("model")
for _name, _spec in SPECS.items():
    model_registry.register(_name, functools.partial(MazeModel, _spec))
for _name, _cls in EXTRAS.items():
    model_registry.register(_name, _cls)


def build_model(cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                seed: Optional[int] = 0) -> nn.Module:
    """Build the registry model ``cfg.name`` on ``device`` (``None`` means
    ``cuda``), randomly initialised from ``seed``: a ``MazeModel`` for the
    ``SPECS`` names, the model's own class for the ``EXTRAS``."""
    if cfg.name not in model_registry:
        raise KeyError(f"unknown model {cfg.name!r}; ported: {model_registry.names()}")
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return model_registry.get(cfg.name)(cfg, device=device, generator=gen)
