"""Waveform-level augmentation on the device (port of ``adfmsl/data/augment.py``).

Rebuild of maze3's train-loop augmentation (maze3.py:577-670: random additive noise
clips + RIR reverb convolution, config-gated, default off). Both transforms are
tensor ops that run inside the train step on the model's device, drawing from
the step's 'augment' generator (``train/state.py``), so augmentation costs no
host round trips.

Each random function is split into its draws and a deterministic part that
takes them (``draw_augment`` / ``apply_augment``, ``mix_at_snr``,
``rir_from_noise``), so the same transform can be fed any draws. adfmsl's
draws, in its order: a noise clip index and an SNR a row, the noise gate's
uniform, an RIR index, the reverb gate's uniform. The reverb acts on the
output of the noise stage; a gated-off row is passed on unchanged
(``torch.where``, an exact select). RIR convolution uses FFT
(``torch.fft``, as adfmsl's XLA FFT); additive noise mixes at a random SNR
drawn per sample.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def mix_at_snr(x: torch.Tensor, n: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """x + n scaled so that x's power over n's is ``snr_db`` (B, 1) a row."""
    px = torch.mean(x * x, dim=-1, keepdim=True)
    pn = torch.mean(n * n, dim=-1, keepdim=True)
    scale = torch.sqrt(px / torch.clamp(pn, min=1e-12) / (10.0 ** (snr_db / 10.0)))
    return x + scale * n


def _draw_noise(b: int, n_noise: int, generator: torch.Generator, snr_db_min: float,
                snr_db_max: float):
    dev = generator.device
    idx = torch.randint(0, n_noise, (b,), generator=generator, device=dev)
    u = torch.rand((b, 1), generator=generator, device=dev)
    return idx, snr_db_min + u * (snr_db_max - snr_db_min)


def add_noise_snr(x: torch.Tensor, noise: torch.Tensor, generator: torch.Generator,
                  snr_db_min: float = 5.0, snr_db_max: float = 20.0) -> torch.Tensor:
    """Mix noise into x at a per-sample random SNR.

    x: (B, T); noise: (N, T) bank of noise clips (tiled/cropped to T beforehand).
    A random clip and a random SNR in [min, max] dB are drawn per batch row.
    """
    idx, snr_db = _draw_noise(x.shape[0], noise.shape[0], generator, snr_db_min,
                              snr_db_max)
    return mix_at_snr(x, noise[idx], snr_db)


def rir_reverb(x: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """Convolve each waveform with a room impulse response (same-length output,
    peak-aligned so direct sound stays at its original position).

    x: (B, T); rir: (R,) or (B, R)."""
    t = x.shape[-1]
    if rir.dim() == 1:
        rir = rir[None, :].expand(x.shape[0], rir.shape[0])
    r = rir.shape[-1]
    # peak-align: measured RIRs carry pre-delay (peak at k>0) which would shift
    # the whole waveform by k samples; rotate each RIR so its peak (the first
    # maximum of |rir|) sits at 0 (synthetic_rir already peaks at 0)
    peak = torch.argmax(torch.abs(rir), dim=-1)
    idx = (torch.arange(r, device=rir.device)[None, :] + peak[:, None]) % r
    rir = torch.gather(rir, -1, idx)
    n = int(2 ** np.ceil(np.log2(t + r - 1)))
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(rir, n=n), n=n)[..., :t]
    # normalise to preserve input energy scale
    ey = torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True))
    ex = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    return y * (ex / torch.clamp(ey, min=1e-12))


def rir_from_noise(noise: torch.Tensor, sample_rate: int = 16000,
                   rt60: float = 0.3) -> torch.Tensor:
    """The synthetic RIR of ``noise`` (R,): noise under a decay of -60 dB at
    ``rt60``, a direct path of 1 at 0, unit energy."""
    t = torch.arange(noise.shape[0], device=noise.device, dtype=torch.float32) / sample_rate
    decay = torch.exp(-6.908 * t / rt60)
    rir = noise * decay
    rir[0] = 1.0
    return rir / torch.sqrt(torch.sum(rir * rir))


def synthetic_rir(generator: torch.Generator, length: int = 2048, sample_rate: int = 16000,
                  rt60: float = 0.3) -> torch.Tensor:
    """Exponentially-decaying noise RIR (the standard synthetic stand-in when no
    measured RIR bank is available), on the generator's device."""
    noise = torch.randn(length, generator=generator, device=generator.device)
    return rir_from_noise(noise, sample_rate, rt60)


@dataclass
class AugmentDraws:
    """One batch's draws; the fields of a bank that is not given are None."""

    noise_idx: Optional[torch.Tensor] = None   # (B,) int64
    snr_db: Optional[torch.Tensor] = None      # (B, 1)
    noise_u: Optional[torch.Tensor] = None     # (B, 1) in [0, 1): the gate's draw
    rir_idx: Optional[torch.Tensor] = None     # (B,) int64
    reverb_u: Optional[torch.Tensor] = None    # (B, 1)


def draw_augment(b: int, generator: torch.Generator, n_noise: Optional[int] = None,
                 n_rir: Optional[int] = None, snr_db_min: float = 5.0,
                 snr_db_max: float = 20.0) -> AugmentDraws:
    """The draws of ``augment_waveform`` for ``b`` rows, in adfmsl's order,
    for banks of ``n_noise`` clips and ``n_rir`` RIRs (None: no bank)."""
    d = AugmentDraws()
    dev = generator.device
    if n_noise is not None:
        d.noise_idx, d.snr_db = _draw_noise(b, n_noise, generator, snr_db_min, snr_db_max)
        d.noise_u = torch.rand((b, 1), generator=generator, device=dev)
    if n_rir is not None:
        d.rir_idx = torch.randint(0, n_rir, (b,), generator=generator, device=dev)
        d.reverb_u = torch.rand((b, 1), generator=generator, device=dev)
    return d


def apply_augment(x: torch.Tensor, draws: AugmentDraws,
                  noise_bank: Optional[torch.Tensor] = None,
                  rir_bank: Optional[torch.Tensor] = None,
                  noise_prob: float = 0.5, reverb_prob: float = 0.3) -> torch.Tensor:
    """The deterministic part of ``augment_waveform``: each transform on the
    rows whose gate draw lies below its probability, the rest passed on as
    they are."""
    out = x
    if noise_bank is not None:
        noised = mix_at_snr(out, noise_bank[draws.noise_idx], draws.snr_db)
        out = torch.where(draws.noise_u < noise_prob, noised, out)
    if rir_bank is not None:
        reverbed = rir_reverb(out, rir_bank[draws.rir_idx])
        out = torch.where(draws.reverb_u < reverb_prob, reverbed, out)
    return out


def augment_waveform(x: torch.Tensor, generator: torch.Generator,
                     noise_bank: Optional[torch.Tensor] = None,
                     rir_bank: Optional[torch.Tensor] = None,
                     noise_prob: float = 0.5, reverb_prob: float = 0.3,
                     snr_db_min: float = 5.0, snr_db_max: float = 20.0) -> torch.Tensor:
    """Config-gated composite augmentation (maze3.py:577-670 semantics: each
    transform applied independently with its own probability, per sample)."""
    draws = draw_augment(x.shape[0], generator,
                         None if noise_bank is None else noise_bank.shape[0],
                         None if rir_bank is None else rir_bank.shape[0],
                         snr_db_min, snr_db_max)
    return apply_augment(x, draws, noise_bank, rir_bank, noise_prob, reverb_prob)
