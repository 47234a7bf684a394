"""LCNN (Light CNN with Max-Feature-Map) on LFCC: port of ``adfmsl/models/lcnn.py``
(``mfm`` :23, ``LCNN`` :29, ``LCNN1D`` :83), with the front-end base the
three spectral models share (LCNN, LCNN1D, ``models/resnet.py:ResNet18``).

Each model splits into ``features(x)`` (the parameterless DSP front end and
CMVN, outside autograd: adfmsl's ``stop_gradient``) and ``classify(feats)`` (trunk,
then head), with ``forward(x) = classify(features(x))``; a caller may feed
``classify`` features it made another way (the fused LFCC kernel K4). Layouts
follow flax's: features (B, frames, coeffs); the 2-D trunk (B, H, W, C), the
1-D trunk (B, T, C). Convolutions run in the trunk dtype; BatchNorm goes
through ``ops/norm.py:bn_forward`` (the batch statistics in train mode). In
train mode the LCNN heads drop out half of the MFM output (adfmsl's fixed
``nn.Dropout(0.5)``, :71, :126), drawn from the 'dropout' generator.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.config.base import ModelConfig
from adfmsl_torch.device import resolve_device
from adfmsl_torch.models.blocks import (conv2d_nhwc, conv_nhc, init_like_flax_,
                                        max_pool2d_nhwc)
from adfmsl_torch.ops.cmvn import cmvn
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.lfcc import lfcc, logmel
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.utils.profiling import annotate


def mfm(x: torch.Tensor) -> torch.Tensor:
    """Max-Feature-Map: split the last (channel) axis in halves, take the max."""
    a, b = x.chunk(2, dim=-1)
    return torch.maximum(a, b)


def mean_pooled(h: torch.Tensor, dims) -> torch.Tensor:
    """Mean over ``dims`` with f32 accumulation, rounded to ``h``'s dtype and
    returned in f32 (``jnp.mean`` of a bf16 tensor, then ``.astype(f32)``)."""
    return h.float().mean(dim=dims).to(h.dtype).float()


class SpectralModel(nn.Module):
    """Base of the LFCC / log-mel models: the front end from ``cfg.frontend``,
    the output contract (adfmsl's: 'logits' (B, 2), 'scores' log-softmax[:, 1],
    'features'), flax-like init from ``generator``, placement on ``device``
    (``None`` means ``cuda``; a missing card raises) in eval mode; ``.train()``
    switches it to training."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def _finish(self, device, generator: Optional[torch.Generator]) -> None:
        self.reset_parameters(generator)
        self.to(resolve_device(device))
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_(self, generator)

    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) f32 waveform -> (B, frames, coeffs) f32 features, outside
        autograd (adfmsl's ``stop_gradient``: nothing is recorded for a
        backward that could only reach the audio)."""
        fe, sr = self.cfg.frontend, self.cfg.architecture.sample_rate
        if fe.name == "lfcc":
            feats = lfcc(x, sr, fe.n_fft, fe.hop_length, fe.win_length, fe.n_filter,
                         fe.n_lfcc, fe.log_eps, precision=fe.dsp_precision,
                         fused_power=fe.fused_power)
        else:
            feats = logmel(x, sr, fe.n_fft, fe.hop_length, fe.win_length, fe.n_mels,
                           fe.fmin, fe.fmax, fe.log_eps, precision=fe.dsp_precision,
                           fused_power=fe.fused_power)
        return cmvn(feats) if fe.cmvn else feats

    def trunk(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, frames, coeffs) -> (B, D) f32 pooled features."""
        raise NotImplementedError

    def head(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def classify(self, feats: torch.Tensor,
                 rngs: Optional[Mapping[str, torch.Generator]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Features -> the output dict, the trunk and the head each under its
        ``stage.model.*`` span; in train mode ``rngs['dropout']`` feeds the
        head's dropout."""
        with annotate("stage.model.trunk"):
            pooled = self.trunk(feats)
        with annotate("stage.model.head"):
            return self.head(pooled, (rngs or {}).get("dropout"))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rngs: Optional[Mapping[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """(B, T) f32 waveform -> the output dict. ``labels`` and ``mask`` are
        taken as ``MazeModel.forward`` takes them, and unused: the loss is the
        configuration's (adfmsl's models ignore them too). The front end runs
        under the ``stage.model.frontend`` span."""
        with annotate("stage.model.frontend"):
            feats = self.features(x)
        return self.classify(feats, rngs)

    @staticmethod
    def outputs(logits: torch.Tensor, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"logits": logits, "scores": torch.log_softmax(logits, dim=-1)[:, 1],
                "features": feats}


class _LCNNHead(SpectralModel):
    """The LCNN head: fc1 -> MFM -> dropout (the identity at eval) -> fc2."""

    head_dropout = 0.5             # adfmsl's fixed rate (lcnn.py:71, :126)

    def head(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        h = dropout(mfm(self.fc1(pooled)), self.head_dropout, generator, self.training)
        return self.outputs(self.fc2(h), h)


class LCNN(_LCNNHead):
    """2-D LCNN: the features as a (frames x coeffs x 1) image; MFM conv stacks
    with 1x1 NIN layers, 2x2 VALID max pools and BatchNorms."""

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.conv1 = nn.Conv2d(1, 64, 5)
        self.nin1 = nn.Conv2d(32, 64, 1)
        self.bn1 = batch_norm(32)
        self.conv2 = nn.Conv2d(32, 96, 3)
        self.bn2 = batch_norm(48)
        self.nin2 = nn.Conv2d(48, 96, 1)
        self.bn3 = batch_norm(48)
        self.conv3 = nn.Conv2d(48, 128, 3)
        self.nin3 = nn.Conv2d(64, 128, 1)
        self.bn4 = batch_norm(64)
        self.conv4 = nn.Conv2d(64, 64, 3)
        self.bn5 = batch_norm(32)
        self.conv5 = nn.Conv2d(32, 64, 3)
        self.fc1 = nn.Linear(32, 160)
        self.fc2 = nn.Linear(80, cfg.architecture.nb_classes)
        self._finish(device, generator)

    def trunk(self, feats: torch.Tensor) -> torch.Tensor:
        dt = self.dtype

        def conv(h, name):
            return mfm(conv2d_nhwc(h, getattr(self, name), dt))

        def bn(h, name):
            return bn_forward(h, getattr(self, name), dt, self.training)

        h = feats[..., None]                                       # (B, F, C, 1)
        h = max_pool2d_nhwc(conv(h, "conv1"), 2, 2)
        h = bn(conv(h, "nin1"), "bn1")
        h = bn(max_pool2d_nhwc(conv(h, "conv2"), 2, 2), "bn2")
        h = bn(conv(h, "nin2"), "bn3")
        h = max_pool2d_nhwc(conv(h, "conv3"), 2, 2)
        h = bn(conv(h, "nin3"), "bn4")
        h = bn(conv(h, "conv4"), "bn5")
        h = max_pool2d_nhwc(conv(h, "conv5"), 2, 2)
        return mean_pooled(h, (1, 2))


class LCNN1D(_LCNNHead):
    """1-D LCNN: the coefficient axis as channels, convolutions over time only;
    blocks conv -> MFM -> BN with 2x VALID max pools."""

    BLOCKS = (("b1", 128, 5), ("b2", 192, 3), ("b3", 256, 3), ("b4", 128, 1),
              ("b5", 128, 3))                                # name, conv channels, k
    POOL_AFTER = ("b1", "b2", "b3", "b5")

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        cin = cfg.frontend.n_lfcc
        for name, cout, k in self.BLOCKS:
            self.add_module(f"{name}_conv", nn.Conv1d(cin, cout, k))
            self.add_module(f"{name}_bn", batch_norm(cout // 2))
            cin = cout // 2
        self.fc1 = nn.Linear(64, 160)
        self.fc2 = nn.Linear(80, cfg.architecture.nb_classes)
        self._finish(device, generator)

    def trunk(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats                                                  # (B, T, n_lfcc)
        for name, *_ in self.BLOCKS:
            h = mfm(conv_nhc(h, getattr(self, f"{name}_conv"), self.dtype))
            h = bn_forward(h, getattr(self, f"{name}_bn"), self.dtype, self.training)
            if name in self.POOL_AFTER:
                h = F.max_pool1d(h.transpose(1, 2), 2, 2).transpose(1, 2)
        return mean_pooled(h, 1)
