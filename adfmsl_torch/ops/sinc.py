"""Trainable sinc band-pass filterbank (SincNet / RawNet front end), vectorized.

Port of ``adfmsl/ops/sinc.py``: ``sinc_init`` (:38), ``_nsinc`` (:48),
``sinc_filters`` (:54, both formulas), ``sinc_conv_nhc`` (:147) as one
``F.conv1d`` and the RawNet front end ``sinc_abs_pool3_nhc`` (:293), with
``conv_precision``, the cuDNN setting those convolutions run under. adfmsl's
other executors (block-GEMM, space-to-depth, time segments) are TPU layout
choices with exact parity, and are not ported.

Parity note: the reference computes ``2*f * torch.sinc(2*f*pi*n)`` where
``torch.sinc(x) = sin(pi x)/(pi x)`` — i.e. the pi lands INSIDE the normalised sinc,
scaling the effective cutoff by pi vs the textbook band-pass.
``formula='textbook'`` (default) gives the standard windowed-sinc band-pass;
``'reference'`` reproduces the reference's (nearly flat) behaviour.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adfmsl_torch.ops.mel import hz_to_mel, mel_to_hz
from adfmsl_torch.ops.window import hann
from adfmsl_torch.utils.profiling import count_sync


def sinc_init(out_channels: int, sample_rate: int = 16000, min_low_hz: float = 50.0,
              min_band_hz: float = 50.0) -> Tuple[np.ndarray, np.ndarray]:
    """Mel-spaced initial (low_hz, band_hz) params — maze4.py:68-78 semantics:
    mel-linspace from 30 Hz to sr/2 - (min_low+min_band), low=edges[:-1], band=diff."""
    low_hz, high_hz = 30.0, sample_rate / 2.0 - (min_low_hz + min_band_hz)
    mel = np.linspace(hz_to_mel(low_hz, htk=True), hz_to_mel(high_hz, htk=True),
                      out_channels + 1)
    hz = mel_to_hz(mel, htk=True)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def _nsinc(x: torch.Tensor) -> torch.Tensor:
    """Normalised sinc: sin(pi x)/(pi x), 1 at 0 (guarded like adfmsl's)."""
    px = math.pi * x
    return torch.where(x.abs() < 1e-9, torch.ones_like(x),
                       torch.sin(px) / torch.where(px == 0, torch.ones_like(px), px))


class _AbsJax(torch.autograd.Function):
    """``|z|`` with ``jnp.abs``'s gradient: slope +1 at z = 0 and at z = -0.0,
    where ``torch.abs`` takes 0. One saved tensor and one elementwise pass in
    the backward, as ``torch.abs``'s own."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return z.abs()

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return torch.where(z < 0, -g, g)


def abs_jax(z: torch.Tensor) -> torch.Tensor:
    """``z.abs()`` whose gradient is ``jnp.abs``'s (+1 at both zeros)."""
    return _AbsJax.apply(z)


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor, kernel_size: int,
                 sample_rate: int = 16000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, formula: str = "textbook") -> torch.Tensor:
    """Synthesize (out_channels, kernel_size) band-pass filters from learnable params.
    An even ``kernel_size`` is bumped by one, as in adfmsl."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    half = (kernel_size - 1) / 2.0
    dev = low_hz.device
    n = (torch.arange(kernel_size, dtype=torch.float32, device=dev) - half) / sample_rate
    window = torch.from_numpy(hann(kernel_size, periodic=False)).to(dev)
    # the window's copy and the two bounds' new_tensor copies block the host
    count_sync(low_hz, 3)

    low = min_low_hz + abs_jax(low_hz)                                   # (C,)
    # jnp.clip's gradient: minimum(maximum(.)), which halves the gradient at a
    # bound where torch.clamp passes all of it; the mel-spaced init puts the
    # last filter's high edge exactly on sample_rate / 2
    high = torch.minimum(torch.maximum(low + min_band_hz + abs_jax(band_hz),
                                       low.new_tensor(min_low_hz)),
                         low.new_tensor(sample_rate / 2.0))
    f_lo = (low / sample_rate)[:, None]                                  # (C,1)
    f_hi = (high / sample_rate)[:, None]
    if formula == "reference":
        # maze4.py:93-95: h = 2*f_norm * torch.sinc(2*f_norm*pi*n_)
        h_hi = 2.0 * f_hi * _nsinc(2.0 * f_hi * math.pi * n[None, :])
        h_lo = 2.0 * f_lo * _nsinc(2.0 * f_lo * math.pi * n[None, :])
    elif formula == "textbook":
        # standard: h(n) = 2 f_hi sinc(2 f_hi n sr) - 2 f_lo sinc(2 f_lo n sr)
        h_hi = 2.0 * f_hi * _nsinc(2.0 * f_hi * sample_rate * n[None, :])
        h_lo = 2.0 * f_lo * _nsinc(2.0 * f_lo * sample_rate * n[None, :])
    else:
        raise ValueError(f"unknown sinc formula {formula!r}")
    return window[None, :] * (h_hi - h_lo)


def conv_precision(exact_fp32: bool):
    """The context the sinc convolutions run in. With ``exact_fp32`` cuDNN
    may not use TF32, which it otherwise does for float32 by default: adfmsl
    pins precision='highest' for float32 maze models (models/mazes.py:123-124)
    and its RawNet conv is exact f32 on the CPU. Otherwise cuDNN's defaults
    stand."""
    if not exact_fp32:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def sinc_conv_nhc(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID filterbank conv: (B, T) x (C, K) -> (B, T-K+1, C),
    channels-last like the trunk. ``F.conv1d`` is a cross-correlation, as
    ``lax.conv`` is, so the filters are not flipped."""
    out = F.conv1d(x[:, None, :], filters[:, None, :])        # (B, C, T')
    return out.transpose(1, 2)


def max_pool3_nhc(x: torch.Tensor) -> torch.Tensor:
    """VALID MaxPool3 over time: (B, T, C) -> (B, T//3, C), the ``T % 3`` tail
    dropped (flax ``max_pool(x, (3,), strides=(3,))``)."""
    b, t, c = x.shape
    return x[:, : t // 3 * 3].reshape(b, t // 3, 3, c).amax(dim=2)


def sinc_abs_pool3_nhc(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """The RawNet front end as a composition: VALID MaxPool3 of
    ``|sinc_conv_nhc(x, filters)|`` -> (B, (T-K+1)//3, C). The magnitude
    takes ``jnp.abs``'s gradient (``abs_jax``), so pool triples that are
    exactly 0 route their gradient as adfmsl's do."""
    return max_pool3_nhc(abs_jax(sinc_conv_nhc(x, filters)))
