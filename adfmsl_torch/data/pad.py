"""Fixed-length crop/pad to 64,600 samples (4 s @ 16 kHz).

Two variants exist in the reference and they are NOT equivalent spectrally:
- tile-repeat (maze2.py:236-242): short clips are tiled until >= max_len, then cropped;
- zero-pad (maze3.py:558-569, Maze5_eval.py:210-214): short clips are right-padded
  with zeros.
Both are exposed; configs pick via ``DataConfig.pad_mode``.

Host variants operate on numpy (inside the loader); ``tile_pad_device`` /
``zero_pad_device`` are the static-shape equivalents on tensors of any device
(adfmsl :47-59): the input is a fixed-capacity buffer plus a true length.
"""
from __future__ import annotations

import numpy as np
import torch


def tile_pad(x: np.ndarray, max_len: int = 64600) -> np.ndarray:
    n = x.shape[0]
    if n == 0:
        return np.zeros(max_len, dtype=x.dtype)
    if n >= max_len:
        return x[:max_len]
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]


def zero_pad(x: np.ndarray, max_len: int = 64600) -> np.ndarray:
    n = x.shape[0]
    if n >= max_len:
        return x[:max_len]
    out = np.zeros(max_len, dtype=x.dtype)
    out[:n] = x
    return out


def pad(x: np.ndarray, max_len: int = 64600, mode: str = "tile") -> np.ndarray:
    if mode == "tile":
        return tile_pad(x, max_len)
    if mode == "zero":
        return zero_pad(x, max_len)
    raise ValueError(f"unknown pad mode {mode!r}")


def tile_pad_device(buf: torch.Tensor, length, max_len: int = 64600) -> torch.Tensor:
    """Static-shape tile-pad: ``buf`` is (max_len,) with the clip in [:length] and
    anything after it ignored. Gathers by modular indexing (``torch.take``
    reads ``buf`` flattened, as ``jnp.take`` does), so the tiling matches
    np.tile's exactly; ``length`` is clamped to at least 1."""
    length = torch.clamp(torch.as_tensor(length, device=buf.device), min=1)
    idx = torch.arange(max_len, device=buf.device)
    src = torch.where(idx < length, idx, idx % length)
    return torch.take(buf, torch.clamp(src, max=max_len - 1))


def zero_pad_device(buf: torch.Tensor, length, max_len: int = 64600) -> torch.Tensor:
    idx = torch.arange(max_len, device=buf.device)
    length = torch.as_tensor(length, device=buf.device)
    return torch.where(idx < length, buf, 0.0)
