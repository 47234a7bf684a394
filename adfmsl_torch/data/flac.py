"""A minimal FLAC writer: mono 16-bit PCM in VERBATIM, CONSTANT or FIXED
subframes (predictor orders 0-4, Rice residuals in one partition).

It writes the vectors and fixtures that hold the native decoder
(``adfmsl_torch/io_native.py``): a FLAC file decodes to exactly the PCM written,
so a FLAC fixture and its 16-bit WAV twin decode to the same samples. CRCs are
written as zeros and the MD5 as zeros (the decoder checks neither). Frames are
packed as numpy bit arrays, so a 4 s utterance takes milliseconds.
"""
from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

from adfmsl_torch.data.audio import read_wav

# FLAC frame-header sample-rate codes; any other rate is read from STREAMINFO (0)
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7,
             32000: 8, 44100: 9, 48000: 10, 96000: 11}
# the fixed predictors' coefficients on x[i-1], x[i-2], ... (FLAC format, FIXED)
_FIXED = {0: (), 1: (1,), 2: (2, -1), 3: (3, -3, 1), 4: (4, -6, 4, -1)}


def _bits(value: int, n: int) -> np.ndarray:
    """The ``n`` low bits of ``value``, most significant first."""
    return ((int(value) >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8)


def _samples(x: np.ndarray, n: int) -> np.ndarray:
    """Each of ``x`` as ``n``-bit two's complement, most significant bit first."""
    v = x.astype(np.int64) & ((1 << n) - 1)
    return ((v[:, None] >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8).ravel()


def _utf8(n: int) -> np.ndarray:
    """FLAC's UTF-8-style coded frame number."""
    if n < 0x80:
        return _bits(n, 8)
    extra = 1
    while n >= 1 << (5 * extra + 6):
        extra += 1
    lead = ((0xFF00 >> (extra + 1)) & 0xFF) | (n >> (6 * extra))
    out = [_bits(lead, 8)]
    for i in range(extra - 1, -1, -1):
        out.append(_bits(0x80 | ((n >> (6 * i)) & 0x3F), 8))
    return np.concatenate(out)


def _rice(residual: np.ndarray) -> np.ndarray:
    """Residual coding method 0, partition order 0: the 4-bit Rice parameter
    k, then each zigzagged residual as q = v >> k zeros, a one and k low bits."""
    v = np.where(residual >= 0, 2 * residual, -2 * residual - 1).astype(np.int64)
    k = int(np.clip(np.floor(np.log2(v.mean() + 1.0)), 0, 14)) if v.size else 0
    q = v >> k
    lengths = q + 1 + k
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    out = np.zeros(int(lengths.sum()), np.uint8)
    out[starts + q] = 1
    for j in range(k):
        out[starts + q + 1 + j] = (v >> (k - 1 - j)) & 1
    return np.concatenate([_bits(0, 2), _bits(0, 4), _bits(k, 4), out])


def _subframe(chunk: np.ndarray, kind: str, order: int) -> np.ndarray:
    if kind == "constant":
        return np.concatenate([_bits(0, 1), _bits(0, 6), _bits(0, 1), _samples(chunk[:1], 16)])
    if kind == "verbatim" or len(chunk) <= order:
        return np.concatenate([_bits(0, 1), _bits(1, 6), _bits(0, 1), _samples(chunk, 16)])
    x = chunk.astype(np.int64)
    pred = np.zeros(len(x) - order, np.int64)
    for j, c in enumerate(_FIXED[order]):
        pred += c * x[order - 1 - j: len(x) - 1 - j]
    return np.concatenate([_bits(0, 1), _bits(8 + order, 6), _bits(0, 1),
                           _samples(x[:order], 16), _rice(x[order:] - pred)])


def write_flac(path: str, pcm: np.ndarray, sr: int = 16000, block_size: int = 4096,
               subframe: str = "fixed", orders: Sequence[int] = (0, 1, 2, 3, 4),
               constant_tail: bool = False) -> None:
    """Write int16 ``pcm`` as a mono 16-bit FLAC file. ``subframe`` is
    'verbatim' or 'fixed'; FIXED frames cycle through the predictor ``orders``
    frame by frame. With ``constant_tail``, a last frame whose samples are all
    equal is written as a CONSTANT subframe."""
    pcm = np.asarray(pcm).astype(np.int16)
    n = len(pcm)
    si = np.concatenate([_bits(block_size, 16), _bits(block_size, 16), _bits(0, 24),
                         _bits(0, 24), _bits(sr, 20), _bits(0, 3), _bits(15, 5),
                         _bits(n, 36), np.zeros(128, np.uint8)])
    out = [b"fLaC", bytes([0x80, 0, 0, len(si) // 8]), np.packbits(si).tobytes()]
    for idx, pos in enumerate(range(0, n, block_size)):
        chunk = pcm[pos: pos + block_size]
        kind = subframe
        if constant_tail and pos + block_size >= n and len(np.unique(chunk)) == 1:
            kind = "constant"
        bits = np.concatenate([
            _bits(0x3FFE, 14), _bits(0, 1), _bits(0, 1),   # sync, reserved, fixed blocking
            _bits(7, 4), _bits(_SR_CODES.get(sr, 0), 4),    # block size follows; rate
            _bits(0, 4), _bits(4, 3), _bits(0, 1),          # mono, 16 bits, reserved
            _utf8(idx), _bits(len(chunk) - 1, 16), _bits(0, 8),   # frame no., size, CRC-8
            _subframe(chunk, kind, orders[idx % len(orders)])])
        bits = np.concatenate([bits, np.zeros(-len(bits) % 8, np.uint8), _bits(0, 16)])
        out.append(np.packbits(bits).tobytes())
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def flac_twin(wav_dir: str, out_dir: str, **kw) -> int:
    """Write each 16-bit ``*.wav`` of ``wav_dir`` as ``<out_dir>/<stem>.flac``
    (``write_flac`` keywords in ``kw``); returns the number of files."""
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
    for p in paths:
        x, sr = read_wav(p)
        stem = os.path.splitext(os.path.basename(p))[0]
        write_flac(os.path.join(out_dir, stem + ".flac"),
                   np.round(x * 32768.0).astype(np.int16), sr, **kw)
    return len(paths)
