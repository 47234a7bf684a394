"""Fused LFCC (raw audio -> LFCC in one pass): kernel K4 on Hopper.

Port of ``adfmsl/ops/pallas/lfcc_fused.py:lfcc_fused`` (:94). Its function,
with its rounding points: centre reflect pad by win/2, framing at ``hop``, the
windowed DFT at the precision tier ``precision`` ('high': bf16 hi/lo split of
both operands, hi*hi + hi*lo + lo*hi in f32, ``_dot3`` :50-61; 'default': one
bf16 pass; 'highest': f32), power re^2 + im^2, the linear filterbank in f32,
log(max(., eps)), the DCT-II in f32. (B, T) f32 -> (B, 1 + T//hop, n_lfcc) f32.

``lfcc_fused`` runs the CUDA kernel (csrc/lfcc_fused.cu) for a CUDA tensor and
the plain PyTorch version (``lfcc_fused_plain``) for a CPU tensor; anything
else raises. The kernel is built with nvcc at its first call (ops/_build.py).
As in adfmsl, no model's front end calls it: ``ops/lfcc.py:lfcc`` is the
models' composition; this is K4's own entry point.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from adfmsl_torch.ops.lfcc import dct_matrix, lfcc
from adfmsl_torch.ops.mel import linear_filterbank
from adfmsl_torch.ops.stft import _dft_matrices

MODES = {"default": 0, "high": 1, "highest": 2}   # csrc/lfcc_fused.cu's Mode
CHUNK_BINS = 16                                   # DFT bins per W chunk in the kernel
MAX_FILTERS = 128
MAX_COEFFS = 128


def lfcc_fused_plain(x: torch.Tensor, sample_rate: int = 16000, n_fft: int = 512,
                     hop_length: int = 160, win_length: int = 400, n_filter: int = 70,
                     n_lfcc: int = 60, log_eps: float = 1e-6,
                     precision: str = "high") -> torch.Tensor:
    """K4's function in plain PyTorch: the LFCC composition with the DFT as
    frames @ [re | im] at the tier's rounding points (ops/stft.py:tiered) and
    exact-f32 filterbank and DCT products. Only the order of the f32 sums
    differs from the kernel."""
    return lfcc(x, sample_rate, n_fft, hop_length, win_length, n_filter, n_lfcc,
                log_eps, impl="matmul", precision=precision)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("lfcc_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lfcc_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
    lib.lfcc_fused_launch.restype = i
    return lib


@functools.lru_cache(maxsize=16)
def kernel_operands(sample_rate: int, n_fft: int, win_length: int, n_filter: int,
                    n_lfcc: int, precision: str, device: torch.device):
    """The kernel's constant operands on ``device``: the DFT matrix in chunks of
    16 bins ((n_chunks, kp, 32): the bins' re columns, then their im columns,
    zero past ``win_length`` and past the last bin) as (hi, lo) at the tier
    ('high': bf16 hi and lo; 'default': bf16, lo None; 'highest': f32, lo
    None); the filterbank (n_chunks*16, 4*ceil(n_filter/4)) f32, zero-padded;
    the DCT (n_filter, n_lfcc) f32. The hi/lo split is the plain version's."""
    cre, cim = _dft_matrices(n_fft, win_length)
    n_bins = n_fft // 2 + 1
    n_chunks = -(-n_bins // CHUNK_BINS)
    kp = 16 * -(-win_length // 16)
    w = np.zeros((n_chunks, kp, 2 * CHUNK_BINS), np.float32)
    for c in range(n_chunks):
        b0, b1 = c * CHUNK_BINS, min((c + 1) * CHUNK_BINS, n_bins)
        w[c, :win_length, :b1 - b0] = cre[:, b0:b1]
        w[c, :win_length, CHUNK_BINS:CHUNK_BINS + b1 - b0] = cim[:, b0:b1]
    fb = np.zeros((n_chunks * CHUNK_BINS, 4 * -(-n_filter // 4)), np.float32)
    fb[:n_bins, :n_filter] = linear_filterbank(sample_rate, n_fft, n_filter)
    wt = torch.from_numpy(w).to(device)
    w_lo = None
    if precision == "highest":
        w_hi = wt
    else:
        w_hi = wt.to(torch.bfloat16)
        if precision == "high":
            w_lo = (wt - w_hi.float()).to(torch.bfloat16)
    return (w_hi, w_lo, torch.from_numpy(fb).to(device),
            torch.from_numpy(dct_matrix(n_filter, n_lfcc)).to(device), n_chunks)


def _launch(x: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
            win_length: int, n_filter: int, n_lfcc: int, log_eps: float,
            precision: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("lfcc_fused: x must be a contiguous (B, T) f32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if precision not in MODES:
        raise ValueError(f"lfcc_fused: precision must be one of {tuple(MODES)}, "
                         f"got {precision!r}")
    bsz, t = x.shape
    if not 0 < bsz <= 65535 or hop_length <= 0 or hop_length % 8 or win_length <= 0:
        raise ValueError(f"lfcc_fused: batch {bsz} (1..65535), hop {hop_length} (a "
                         f"multiple of 8), win {win_length}")
    if win_length // 2 >= t:
        raise ValueError(f"lfcc_fused: T={t} is too short to reflect-pad by "
                         f"{win_length // 2}")
    if not 0 < n_filter <= MAX_FILTERS or not 0 < n_lfcc <= MAX_COEFFS:
        raise ValueError(f"lfcc_fused: {n_filter} filters and {n_lfcc} coefficients "
                         f"(at most {MAX_FILTERS} each)")
    w_hi, w_lo, fb, dct, n_chunks = kernel_operands(
        sample_rate, n_fft, win_length, n_filter, n_lfcc, precision, x.device)
    lib = _kernel_lib()
    n_frames = 1 + (t + 2 * (win_length // 2) - win_length) // hop_length
    out = torch.empty((bsz, n_frames, n_lfcc), dtype=torch.float32, device=x.device)
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lfcc_fused_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_hi.data_ptr()),
            ctypes.c_void_p(w_lo.data_ptr() if w_lo is not None else 0),
            ctypes.c_void_p(fb.data_ptr()), ctypes.c_void_p(dct.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), bsz, t, hop_length, win_length, n_chunks,
            n_filter, n_lfcc, ctypes.c_float(log_eps), MODES[precision], dev.index,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lfcc_fused: kernel launch failed with CUDA error {rc}")
    lfcc_fused.launches += 1
    return out


def lfcc_fused(x: torch.Tensor, sample_rate: int = 16000, n_fft: int = 512,
               hop_length: int = 160, win_length: int = 400, n_filter: int = 70,
               n_lfcc: int = 60, log_eps: float = 1e-6,
               precision: str = "high") -> torch.Tensor:
    """(B, T) f32 waveform -> (B, 1 + T//hop, n_lfcc) f32 LFCC.

    A CUDA ``x`` launches the K4 kernel (and counts the launch in
    ``lfcc_fused.launches``) or raises; a CPU ``x`` runs the plain version."""
    args = (sample_rate, n_fft, hop_length, win_length, n_filter, n_lfcc, log_eps,
            precision)
    if x.device.type == "cuda":
        return _launch(x, *args)
    if x.device.type == "cpu":
        return lfcc_fused_plain(x, *args)
    raise ValueError(f"lfcc_fused: unsupported device {x.device}")


lfcc_fused.launches = 0
