"""Audio decode: FLAC and WAV (the native C++ decoder, ``io_native``), WAV in
pure numpy where asked, and resampling.

The port's copy of ``adfmsl/data/audio.py``. The reference leans on librosa
(libsndfile) to decode ASVspoof FLAC and resample to 16 kHz (maze2.py:265).
FLAC always goes through the native decoder; WAV through it by default and
through ``read_wav`` (numpy) with ``prefer_native=False``.
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM (8/16/32-bit) and IEEE float32. Returns mono
    float32 in [-1, 1] (channels averaged) plus the sample rate."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:   # IEEE float32
        x = np.frombuffer(raw, dtype=np.float32).astype(np.float32)
    elif audio_fmt == 3 and bits == 64:  # IEEE float64 (scipy.io.wavfile output)
        x = np.frombuffer(raw, dtype=np.float64).astype(np.float32)
    elif audio_fmt == 1 and bits in _PCM_DTYPES:
        x = np.frombuffer(raw, dtype=_PCM_DTYPES[bits]).astype(np.float32)
        if bits == 8:
            x = (x - 128.0) / 128.0
        else:
            x = x / float(2 ** (bits - 1))
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}/{bits}bit")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (kaiser-windowed FIR), the same family of algorithm as
    librosa's 'kaiser_best'/soxr path; exact parity is not required because training
    and eval both run through this resampler."""
    if sr == target_sr:
        return x
    g = np.gcd(sr, target_sr)
    # imported here: scipy.signal takes seconds to import, and every spawned
    # rank imports this module
    from scipy.signal import resample_poly

    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def load_audio(path: str, target_sr: int = 16000,
               prefer_native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode FLAC/WAV to mono float32 at ``target_sr`` (librosa.load analog).

    ``prefer_native=False`` keeps WAV decode in pure numpy (DataConfig.use_native_io
    off); FLAC always goes through the native decoder. A WAV format the
    native decoder does not read (8-bit PCM) goes to numpy, as in adfmsl; a
    failed build of the decoder raises.
    """
    from adfmsl_torch.io_native import decode_flac, decode_wav_native

    ext = os.path.splitext(path)[1].lower()
    if ext == ".flac":
        x, sr = decode_flac(path)
    elif prefer_native:
        try:
            x, sr = decode_wav_native(path)
        except ValueError:
            x, sr = read_wav(path)
    else:
        x, sr = read_wav(path)
    return resample(x, sr, target_sr), target_sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """16-bit PCM writer (used by the synthetic-fixture generator)."""
    x = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype(np.int16).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as fh:
        fh.write(hdr + pcm)
