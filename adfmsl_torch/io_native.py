"""ctypes binding of the port's native audio IO library (``libadfmsl_torch_io.so``).

The port's copy of ``adfmsl/io_native/__init__.py``: FLAC decode (the
ASVspoof distribution format), WAV decode, and a thread-pooled batch loader
that decodes and pads a whole batch in one call. The library is compiled from
``adfmsl_torch/csrc/audio_decode.cc`` with the host's C++ compiler at first use
(``ops/_build.py``). adfmsl falls back to numpy when its prebuilt library is
absent; the port always builds its own, so a failed build is a fault and
raises with the compiler's log. The numpy WAV reader is used only where the
caller asks for it (``load_audio(prefer_native=False)``,
``AsvspoofDataset(use_native_io=False)``).
"""
from __future__ import annotations

import ctypes
import functools
import logging
from typing import List, Tuple

import numpy as np

from adfmsl_torch.ops import _build

LIBRARY = "adfmsl_torch_io"
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library(LIBRARY)
    lib.adfmsl_decode.restype = ctypes.c_int64
    lib.adfmsl_decode.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64, _I32P]
    lib.adfmsl_decode_len.restype = ctypes.c_int64
    lib.adfmsl_decode_len.argtypes = [ctypes.c_char_p]
    lib.adfmsl_batch_decode_pad.restype = ctypes.c_int32
    lib.adfmsl_batch_decode_pad.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,   # paths, n
        _F32P, ctypes.c_int64,                             # out, max_len
        _I32P, _I32P,                                      # out sample rates, lengths
        ctypes.c_int32, ctypes.c_int32,                    # pad_mode (0 tile, 1 zero), n_threads
    ]
    return lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return _lib() is not None


def _decode(path: str) -> Tuple[np.ndarray, int]:
    lib = _lib()
    n = lib.adfmsl_decode_len(path.encode())
    if n < 0:
        raise ValueError(f"cannot decode {path} (err {n})")
    out = np.empty(n, dtype=np.float32)
    sr = ctypes.c_int32(0)
    got = lib.adfmsl_decode(path.encode(), out.ctypes.data_as(_F32P), n, ctypes.byref(sr))
    if got < 0:
        raise ValueError(f"cannot decode {path} (err {got})")
    return out[:got], int(sr.value)


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC file -> (mono f32 samples in [-1, 1), sample rate)."""
    return _decode(path)


def decode_wav_native(path: str) -> Tuple[np.ndarray, int]:
    """WAV file (16/32-bit PCM, f32/f64 float) -> (mono f32 samples, sample rate)."""
    return _decode(path)


def batch_decode_pad(
    paths: List[str], max_len: int = 64600, pad_mode: str = "tile", n_threads: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode+pad a batch of files in native threads. Returns
    (audio [B, max_len] f32, sample_rates [B] i32, true_lengths [B] i32).
    A missing file gives a zero row with rate and length 0; a corrupt one too,
    with a warning."""
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, max_len), dtype=np.float32)
    srs = np.zeros(n, dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.adfmsl_batch_decode_pad(
        arr, n, out.ctypes.data_as(_F32P), max_len,
        srs.ctypes.data_as(_I32P), lens.ctypes.data_as(_I32P),
        0 if pad_mode == "tile" else 1, n_threads,
    )
    if rc < 0:
        raise RuntimeError(f"batch decode failed (rc={rc})")
    if rc > 0:   # corrupt files were zero-filled (reference failure tolerance)
        logging.getLogger(__name__).warning(
            "batch decode: %d corrupt file(s) zero-filled", rc)
    return out, srs, lens
