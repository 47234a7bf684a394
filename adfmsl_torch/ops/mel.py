"""Mel / linear filterbanks: port of ``adfmsl/ops/mel.py``.

The filterbanks are built once on the host in float64 (numpy) and cached, as
in adfmsl; the per-step work is one f32 (frames x bins) @ (bins x n_f)
product. Formulas follow the HTK / Slaney definitions (librosa.filters.mel
with ``norm='slaney', htk=False`` by default).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from adfmsl_torch.ops.stft import exact_f32


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    # maximum() keeps log() off f=0 (that branch is discarded by the where)
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def _triangle_bank(edges_hz: np.ndarray, n_fft: int, sample_rate: int,
                   norm: Optional[str]) -> np.ndarray:
    """Triangular filters with given (n_filters+2,) edge frequencies -> (bins, n_f)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    n_f = len(edges_hz) - 2
    fb = np.zeros((n_bins, n_f), dtype=np.float64)
    for i in range(n_f):
        lo, ctr, hi = edges_hz[i], edges_hz[i + 1], edges_hz[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (edges_hz[2:] - edges_hz[:-2])
        fb *= enorm[None, :]
    return fb


@lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int = 16000, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney") -> np.ndarray:
    """(n_bins, n_mels) mel filterbank matrix (float32)."""
    fmax = fmax or sample_rate / 2.0
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    edges = mel_to_hz(mels, htk)
    return _triangle_bank(edges, n_fft, sample_rate, norm).astype(np.float32)


@lru_cache(maxsize=16)
def linear_filterbank(sample_rate: int = 16000, n_fft: int = 512, n_filter: int = 70,
                      fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """(n_bins, n_filter) linearly-spaced triangular filterbank (LFCC front end)."""
    fmax = fmax or sample_rate / 2.0
    edges = np.linspace(fmin, fmax, n_filter + 2)
    return _triangle_bank(edges, n_fft, sample_rate, norm=None).astype(np.float32)


def apply_filterbank(power_spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., frames, bins) @ (bins, n_f) -> (..., frames, n_f), exact f32."""
    with exact_f32():
        return torch.matmul(power_spec, fb)


def log_compress(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=eps))
