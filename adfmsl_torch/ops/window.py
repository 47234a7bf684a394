"""Windows and framing: port of ``adfmsl/ops/window.py`` (``hann`` :13,
``frame`` :24, ``num_frames`` :42)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window. ``periodic=True`` matches torch.hann_window default / STFT usage;
    ``periodic=False`` the symmetric window the reference SincConv uses
    (maze4.py:82 ``torch.hann_window(kernel_size, periodic=False)``)."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(dtype)


def center_pad(x: torch.Tensor, frame_length: int, pad_mode: str = "reflect") -> torch.Tensor:
    """Pad the last axis of (..., T) by frame_length//2 on both sides
    (``jnp.pad``'s 'reflect' excludes the edge sample, as torch's does)."""
    pad = frame_length // 2
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
    return y.reshape(*lead, y.shape[-1])


def frame(x: torch.Tensor, frame_length: int, hop: int, center: bool = True,
          pad_mode: str = "reflect") -> torch.Tensor:
    """Slice (..., T) signal into (..., n_frames, frame_length) overlapping frames.

    ``center=True`` reflect-pads by frame_length//2 on both sides (librosa.stft
    default), so frame t is centered on sample t*hop.
    """
    if center:
        x = center_pad(x, frame_length, pad_mode)
    return x.unfold(-1, frame_length, hop)


def num_frames(n_samples: int, frame_length: int, hop: int, center: bool = True) -> int:
    n = n_samples + 2 * (frame_length // 2) if center else n_samples
    return 1 + (n - frame_length) // hop
