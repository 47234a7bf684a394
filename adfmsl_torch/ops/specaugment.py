"""SpecAugment: frequency / time masking of feature maps (port of
``adfmsl/ops/specaugment.py``, :19-65).

Two mask semantics, as in adfmsl:
- 'torchaudio': width v ~ U[0, param) (param clamped to the axis), start ~
  U[0, size - v]; zeros [start, start + v).
- 'reference_handrolled' (maze4_fmsl_standardized.py:193-214): start ~
  U[0, param), end ~ U[start, size); zeros [start, end).

Masks are drawn per sample (adfmsl's choice; the reference scripts draw one
per batch), frequency masks first, then time masks, from one generator. The
draws depend only on the axis sizes, so ``channels_last`` gives the masks of
the transposed layout.
"""
from __future__ import annotations

import torch


def _mask_axis(gen: torch.Generator, b: int, size: int, param: int, n_masks: int,
               semantics: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Multiplicative {0, 1} mask of shape (B, size), the product of
    ``n_masks`` per-sample masks."""
    keep = torch.ones((b, size), dtype=dtype, device=device)
    idx = torch.arange(size, device=device)[None, :]
    for _ in range(n_masks):
        if semantics == "torchaudio":
            v = torch.randint(0, max(min(param, size), 1), (b, 1), generator=gen,
                              device=device)
            u = torch.rand((b, 1), generator=gen, device=device)
            start = torch.floor(u * (size - v + 1)).long()
            end = start + v
        elif semantics == "reference_handrolled":
            start = torch.randint(0, max(param, 1), (b, 1), generator=gen, device=device)
            u = torch.rand((b, 1), generator=gen, device=device)
            end = start + torch.floor(u * (size - start)).long()
        else:
            raise ValueError(f"unknown SpecAugment semantics {semantics!r}")
        keep = keep * ((idx < start) | (idx >= end)).to(dtype)
    return keep


def spec_augment(x: torch.Tensor, gen: torch.Generator, freq_mask_param: int = 10,
                 time_mask_param: int = 10, n_freq_masks: int = 2,
                 n_time_masks: int = 2, semantics: str = "torchaudio",
                 channels_last: bool = False) -> torch.Tensor:
    """Mask (B, C, T), or (B, T, C) with ``channels_last``; C is the
    frequency / channel axis, T is time."""
    if channels_last:
        b, t, c = x.shape
    else:
        b, c, t = x.shape
    fmask = _mask_axis(gen, b, c, freq_mask_param, n_freq_masks, semantics,
                       x.dtype, x.device)
    tmask = _mask_axis(gen, b, t, time_mask_param, n_time_masks, semantics,
                       x.dtype, x.device)
    if channels_last:
        return x * fmask[:, None, :] * tmask[:, :, None]
    return x * fmask[:, :, None] * tmask[:, None, :]
