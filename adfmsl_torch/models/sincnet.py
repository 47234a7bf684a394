"""Trainable SincConv front end (port of ``adfmsl/models/sincnet.py:SincConv``,
stride 1). Output layout (B, T', C).

``post='none'`` is the plain filterbank conv (maze4 / maze5). ``post='abs_pool3'``
is the RawNet front end, VALID MaxPool3 of ``|conv|`` -> (B, T3, C), with
adfmsl's dispatch (:82-107): with ``fused_train`` in train mode, or
``fused_eval`` at eval, and a batch of at most ``fused_max_batch`` rows it runs
kernel K3 (``ops/sinc_fused.py``; in train mode through ``sinc_abs_pool``,
whose backward recomputes the composition), otherwise the f32 composition
(``ops/sinc.py:sinc_abs_pool3_nhc``).

With ``post='none'``, ``forward``'s ``bn_act`` (the eval BatchNorm's operands
after the conv, ``ops/norm.py:eval_affine``) runs the conv, that BatchNorm and
SELU together as kernel K5 (``ops/sinc_bn_act.py``); ``MazeModel`` decides when.
"""
from __future__ import annotations

import torch
from torch import nn

from adfmsl_torch.ops.sinc import (conv_precision, sinc_abs_pool3_nhc, sinc_conv_nhc,
                                   sinc_filters, sinc_init)
from adfmsl_torch.ops.sinc_bn_act import sinc_bn_act_fused
from adfmsl_torch.ops.sinc_fused import sinc_abs_pool, sinc_abs_pool_fused


class SincConv(nn.Module):
    def __init__(self, out_channels: int = 128, kernel_size: int = 251,
                 sample_rate: int = 16000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, formula: str = "textbook",
                 exact_fp32: bool = False, post: str = "none",
                 fused_eval: bool = False, fused_train: bool = False,
                 fused_max_batch: int = 16):
        super().__init__()
        if post not in ("none", "abs_pool3"):
            raise ValueError(f"unknown SincConv post {post!r}")
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        self.formula = formula
        self.exact_fp32 = exact_fp32          # see ops/sinc.py:conv_precision
        self.post = post
        self.fused_eval = fused_eval
        self.fused_train = fused_train
        self.fused_max_batch = fused_max_batch
        low, band = sinc_init(out_channels, sample_rate, min_low_hz, min_band_hz)
        self.low_hz = nn.Parameter(torch.from_numpy(low))
        self.band_hz = nn.Parameter(torch.from_numpy(band))

    def reset_parameters(self) -> None:
        low, band = sinc_init(self.out_channels, self.sample_rate,
                              self.min_low_hz, self.min_band_hz)
        with torch.no_grad():
            self.low_hz.copy_(torch.from_numpy(low))
            self.band_hz.copy_(torch.from_numpy(band))

    def filters(self) -> torch.Tensor:
        return sinc_filters(self.low_hz, self.band_hz, self.kernel_size,
                            self.sample_rate, self.min_low_hz, self.min_band_hz,
                            self.formula)

    def forward(self, x: torch.Tensor, bn_act=None) -> torch.Tensor:
        """(B, T) f32 waveform -> (B, T-K+1, C) f32, or (B, (T-K+1)//3, C)
        with ``post='abs_pool3'``. With ``bn_act``, the (mean, mul, bias) of
        the eval BatchNorm that follows, -> SELU of that BatchNorm of the
        conv, (B, T-K+1, C) bf16, through K5."""
        filt = self.filters()
        if bn_act is not None:
            return sinc_bn_act_fused(x.contiguous(), filt, *bn_act)
        if self.post == "abs_pool3":
            fused = self.fused_train if self.training else self.fused_eval
            if fused and x.shape[0] <= self.fused_max_batch:
                if self.training:
                    return sinc_abs_pool(x, filt, self.exact_fp32)
                return sinc_abs_pool_fused(x.contiguous(), filt)
            composition = sinc_abs_pool3_nhc
        else:
            composition = sinc_conv_nhc
        with conv_precision(self.exact_fp32):
            return composition(x, filt)
