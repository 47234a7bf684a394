"""Windows (the port's copy of ``adfmsl/ops/window.py:hann``)."""
from __future__ import annotations

import numpy as np


def hann(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window. ``periodic=True`` matches torch.hann_window default / STFT usage;
    ``periodic=False`` the symmetric window the reference SincConv uses
    (maze4.py:82 ``torch.hann_window(kernel_size, periodic=False)``)."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(dtype)
