"""HTK mel scale (the part of ``adfmsl/ops/mel.py`` that ``sinc_init`` needs;
the filterbanks come with the LFCC/log-mel front ends, ROADMAP slice 5)."""
from __future__ import annotations

import numpy as np


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
