"""STFT power spectrograms: port of ``adfmsl/ops/stft.py``.

Four interchangeable implementations of |STFT|^2 with the periodic Hann window
folded into the DFT matrices (``_dft_matrices`` :25): ``stft_matmul`` (frames
@ DFT), ``stft_conv`` (one strided conv over the raw waveform), ``stft_s2d``
(hop-sized blocks as channels, a dense stride-1 conv; adfmsl's default) and
``stft_fft`` (framing + rfft; reference semantics). The products are plain
large cuDNN / cuBLAS calls, as adfmsl leaves them to XLA.

Precision tiers of the DFT product (adfmsl :40-48, TPU semantics, the same on
every device; 'fft' has no tier):

- 'highest': exact f32, TF32 off for that call;
- 'high': operands split into bf16 hi/lo, hi*hi + hi*lo + lo*hi accumulated
  in f32 (the bf16x3 of ``adfmsl/ops/pallas/lfcc_fused.py:_dot3``);
- 'default': one pass over bf16-rounded operands.

A bf16-rounded f32 tensor is exact in TF32, so 'high' and 'default' run as f32
products of pre-rounded operands with TF32 allowed: every product is exact and
the sums are f32 either way.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from adfmsl_torch.ops.window import center_pad, frame, hann

PRECISIONS = ("highest", "high", "default")


@contextlib.contextmanager
def _tf32(enabled: bool):
    """Allow or forbid TF32 in cuBLAS and cuDNN for the calls inside; the
    caller's settings come back afterwards."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, dnn


def exact_f32():
    """Context for f32 products that must be exact f32 (adfmsl's HIGHEST)."""
    return _tf32(False)


def bf16_round(v: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 (ties to even), kept in f32."""
    return v.to(torch.bfloat16).float()


def tiered(op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], a: torch.Tensor,
           w: torch.Tensor, precision: str) -> torch.Tensor:
    """``op(a, w)`` for a product ``op`` bilinear in its f32 operands, at the
    precision tier ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "highest":
        with _tf32(False):
            return op(a, w)
    a_hi, w_hi = bf16_round(a), bf16_round(w)
    with _tf32(True):
        if precision == "default":
            return op(a_hi, w_hi)
        a_lo, w_lo = bf16_round(a - a_hi), bf16_round(w - w_hi)
        return op(a_hi, w_hi) + op(a_hi, w_lo) + op(a_lo, w_hi)


@lru_cache(maxsize=16)
def _dft_matrices(n_fft: int, win_length: int, dtype=np.float32):
    """Real/imag DFT matrices, window folded in: (win_length, n_bins) each."""
    n_bins = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]          # sample index within frame
    k = np.arange(n_bins)[None, :]              # bin index
    ang = -2.0 * np.pi * n * k / n_fft
    w = hann(win_length, periodic=True).astype(np.float64)[:, None]
    return (np.cos(ang) * w).astype(dtype), (np.sin(ang) * w).astype(dtype)


@lru_cache(maxsize=64)
def device_const(fn: Callable[..., np.ndarray], args: tuple,
                 device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a cached numpy constant) as an f32 tensor on ``device``,
    copied there once."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args), dtype=np.float32)).to(device)


def _dft_cat(n_fft: int, win_length: int) -> np.ndarray:
    """(win_length, 2*n_bins): [re | im]."""
    return np.concatenate(_dft_matrices(n_fft, win_length), axis=1)


def _s2d_kernel(n_fft: int, hop_length: int, win_length: int) -> np.ndarray:
    """(2*n_bins, hop, wb) conv weight of ``stft_s2d``: the [re | im] DFT rows
    in blocks of ``hop``, zero past ``win_length``."""
    wb = -(-win_length // hop_length)
    cat = _dft_cat(n_fft, win_length)
    k = np.zeros((wb * hop_length, cat.shape[1]), np.float32)
    k[:win_length] = cat
    return k.reshape(wb, hop_length, -1).transpose(2, 1, 0)


def _power(out: torch.Tensor, n_fft: int) -> torch.Tensor:
    n_bins = n_fft // 2 + 1
    re, im = out[..., :n_bins], out[..., n_bins:]
    return re * re + im * im


def stft_matmul(x: torch.Tensor, n_fft: int = 512, hop_length: int = 160,
                win_length: int = 400, center: bool = True,
                precision: str = "high") -> torch.Tensor:
    """Power spectrogram |STFT|^2 via matmul. x: (..., T) -> (..., frames, bins)."""
    frames = frame(x, win_length, hop_length, center=center)
    w = device_const(_dft_cat, (n_fft, win_length), x.device)
    return _power(tiered(torch.matmul, frames, w, precision), n_fft)


def stft_conv(x: torch.Tensor, n_fft: int = 512, hop_length: int = 160,
              win_length: int = 400, center: bool = True,
              precision: str = "high") -> torch.Tensor:
    """Power spectrogram as ONE strided convolution whose (2*n_bins, 1, win)
    kernel holds the [re | im] DFT matrices. x: (..., T) -> (..., frames, bins)."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        x = center_pad(x, win_length)
    w = device_const(_dft_cat, (n_fft, win_length), x.device).T[:, None, :]
    out = tiered(lambda a, k: F.conv1d(a, k, stride=hop_length), x[:, None, :], w, precision)
    p = _power(out.transpose(1, 2), n_fft)
    return p.reshape(*lead, *p.shape[1:])


def stft_s2d(x: torch.Tensor, n_fft: int = 512, hop_length: int = 160,
             win_length: int = 400, center: bool = True,
             precision: str = "high", raw: bool = False) -> torch.Tensor:
    """Power spectrogram via a space-to-depth conv: the waveform reshaped to
    (B, T//hop, hop) blocks as channels, the stride-``hop`` window a dense
    stride-1 conv over ``ceil(win/hop)`` blocks whose kernel rows past
    ``win_length`` are zero. Same math as ``stft_matmul``.

    ``raw=True`` returns the pre-power (..., frames, 2*n_bins) [re | im]."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        x = center_pad(x, win_length)
    m = x.shape[1]
    n_frames = (m - win_length) // hop_length + 1
    wb = -(-win_length // hop_length)            # window span in blocks
    need = (n_frames + wb - 1) * hop_length
    if m < need:
        # the zero tail only meets the kernel's zero rows or frames >= n_frames
        x = F.pad(x, (0, need - m))
    blocks = x[:, :need].reshape(-1, need // hop_length, hop_length).transpose(1, 2)
    k = device_const(_s2d_kernel, (n_fft, hop_length, win_length), x.device)
    out = tiered(F.conv1d, blocks, k, precision)[:, :, :n_frames].transpose(1, 2)
    if not raw:
        out = _power(out, n_fft)
    return out.reshape(*lead, *out.shape[1:])


def stft_fft(x: torch.Tensor, n_fft: int = 512, hop_length: int = 160,
             win_length: int = 400, center: bool = True,
             precision: str = "high") -> torch.Tensor:
    """Power spectrogram via rfft (reference semantics: window padded to n_fft;
    no precision tier)."""
    frames = frame(x, win_length, hop_length, center=center)
    fr = frames * device_const(hann, (win_length,), x.device)
    if win_length < n_fft:
        fr = F.pad(fr, (0, n_fft - win_length))
    return torch.abs(torch.fft.rfft(fr, n=n_fft, dim=-1)) ** 2


def power_spectrogram(x, n_fft=512, hop_length=160, win_length=400, center=True,
                      impl: str = "s2d", precision: str = "high") -> torch.Tensor:
    fn = {"matmul": stft_matmul, "fft": stft_fft, "conv": stft_conv,
          "s2d": stft_s2d}[impl]
    return fn(x, n_fft, hop_length, win_length, center, precision=precision)
