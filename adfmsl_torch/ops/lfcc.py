"""LFCC and log-mel front ends: port of ``adfmsl/ops/lfcc.py``.

LFCC = orthonormal DCT-II over log linear-filterbank energies (the ASVspoof
countermeasure front end); log-mel the same without the DCT over a Slaney mel
filterbank. The DFT product runs at the precision tier ``precision``
(ops/stft.py); the filterbank and DCT products are exact f32, adfmsl's
HIGHEST. This composition never calls the fused kernel K4
(``ops/lfcc_fused.py``), as adfmsl's ``lfcc`` never calls its Pallas twin.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from adfmsl_torch.ops.mel import (apply_filterbank, linear_filterbank, log_compress,
                                  mel_filterbank)
from adfmsl_torch.ops.stft import device_const, exact_f32, power_spectrogram, stft_s2d


@lru_cache(maxsize=8)
def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_in, n_out) — scipy.fft.dct(norm='ortho') semantics."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    m = np.cos(np.pi * (2 * n + 1) * k / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    m[:, 0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def _stacked(fb_fn, args) -> np.ndarray:
    """[fb; fb] over the s2d conv's [re | im] columns."""
    fb = fb_fn(*args)
    return np.concatenate([fb, fb], axis=0)


def _log_energies(x, fb_fn, fb_args, n_fft, hop_length, win_length, log_eps, impl,
                  precision, fused_power) -> torch.Tensor:
    """log(max(|STFT|^2 @ fb, eps)). With ``fused_power`` (s2d only) the
    square is taken on the raw [re | im] conv output and the stacked [fb; fb]
    sums re^2 and im^2 inside the filterbank product (adfmsl :51-60)."""
    if fused_power and impl == "s2d":
        out = stft_s2d(x, n_fft, hop_length, win_length, precision=precision, raw=True)
        fb2 = device_const(_stacked, (fb_fn, fb_args), x.device)
        with exact_f32():
            e = torch.matmul(out * out, fb2)
    else:
        p = power_spectrogram(x, n_fft, hop_length, win_length, impl=impl,
                              precision=precision)
        e = apply_filterbank(p, device_const(fb_fn, fb_args, x.device))
    return log_compress(e, log_eps)


def lfcc(x: torch.Tensor, sample_rate: int = 16000, n_fft: int = 512,
         hop_length: int = 160, win_length: int = 400, n_filter: int = 70,
         n_lfcc: int = 60, log_eps: float = 1e-6, impl: str = "s2d",
         precision: str = "high", fused_power: bool = False) -> torch.Tensor:
    """(..., T) waveform -> (..., frames, n_lfcc) f32."""
    e = _log_energies(x, linear_filterbank, (sample_rate, n_fft, n_filter), n_fft,
                      hop_length, win_length, log_eps, impl, precision, fused_power)
    with exact_f32():
        return torch.matmul(e, device_const(dct_matrix, (n_filter, n_lfcc), x.device))


def logmel(x: torch.Tensor, sample_rate: int = 16000, n_fft: int = 512,
           hop_length: int = 160, win_length: int = 400, n_mels: int = 80,
           fmin: float = 0.0, fmax=None, log_eps: float = 1e-6,
           impl: str = "s2d", precision: str = "high",
           fused_power: bool = False) -> torch.Tensor:
    """(..., T) waveform -> (..., frames, n_mels) log-mel spectrogram, f32."""
    return _log_energies(x, mel_filterbank, (sample_rate, n_fft, n_mels, fmin, fmax),
                         n_fft, hop_length, win_length, log_eps, impl, precision,
                         fused_power)
