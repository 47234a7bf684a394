"""Fixed-length crop/pad to 64,600 samples (4 s @ 16 kHz).

Two variants exist in the reference and they are NOT equivalent spectrally:
- tile-repeat (maze2.py:236-242): short clips are tiled until >= max_len, then cropped;
- zero-pad (maze3.py:558-569, Maze5_eval.py:210-214): short clips are right-padded
  with zeros.
Both are exposed; configs pick via ``DataConfig.pad_mode``.

These are the host variants of ``adfmsl/data/pad.py`` (numpy, inside the loader);
its on-device variants are not ported.
"""
from __future__ import annotations

import numpy as np


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
