"""Trainable SincConv front end (port of ``adfmsl/models/sincnet.py:SincConv``
with ``post='none'``, stride 1). Output layout (B, T', C)."""
from __future__ import annotations

import torch
from torch import nn

from adfmsl_torch.ops.sinc import sinc_conv_nhc, sinc_filters, sinc_init


class SincConv(nn.Module):
    def __init__(self, out_channels: int = 128, kernel_size: int = 251,
                 sample_rate: int = 16000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, formula: str = "textbook",
                 exact_fp32: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        self.formula = formula
        # adfmsl pins precision='highest' for float32 models
        # (models/mazes.py:123-124); the card's counterpart is a cuDNN conv
        # without TF32, which cuDNN otherwise uses for float32 by default
        self.exact_fp32 = exact_fp32
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) f32 waveform -> (B, T-K+1, C) f32."""
        filt = self.filters()
        if self.exact_fp32:
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic, allow_tf32=False):
                return sinc_conv_nhc(x, filt)
        return sinc_conv_nhc(x, filt)
