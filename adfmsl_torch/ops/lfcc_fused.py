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

'high' and 'default' run on the tensor-core engine of csrc/lfcc_fused.cu, whose
operands ``kernel_operands`` lays out here: the DFT matrix as (chunk, k-slice)
stages in the no-swizzle K-major core-matrix layout of a ``wgmma`` B operand,
re and im of each bin in adjacent columns, and the filterbank as per-filter
runs of bins (CSR). ``tc_smem_layout`` is the kernel's shared-memory formula
(``csrc/lfcc_fused.cu:tc_layout``); the wrapper refuses a shape it does not fit
before anything is built. 'highest' keeps the CUDA-core kernel and its dense
operands.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from adfmsl_torch.ops.lfcc import dct_matrix, lfcc
from adfmsl_torch.ops.mel import linear_filterbank
from adfmsl_torch.ops.stft import _dft_matrices

MODES = {"default": 0, "high": 1, "highest": 2}   # csrc/lfcc_fused.cu's Mode
MAX_FILTERS = 128
MAX_COEFFS = 128
# the tensor-core engine ('high', 'default'); csrc/lfcc_fused.cu's constants
TILE_FRAMES = 64                 # frames a warpgroup tile; a CTA holds one or two
CHUNK_BINS = 32                  # DFT bins a chunk: N = 64 columns, re / im interleaved
K_SLICE = 80                     # DFT taps a W stage
SLICE_ELEMS = 2 * CHUNK_BINS * K_SLICE
POWER_PITCH = CHUNK_BINS + 1     # f32 power stage row pitch
SMEM_LIMIT = 232448              # 227 KB: the most a CTA may take on an H100
BARRIER_BYTES = 128
# the 'highest' CUDA-core kernel
HIGHEST_CHUNK_BINS = 16


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


def _align128(v: int) -> int:
    return (v + 127) & ~127


def tc_smem_layout(hop: int, win: int, n_filter: int, n_lfcc: int, precision: str,
                   fb_words: int) -> Optional[dict]:
    """The tensor-core engine's shared memory for one CTA, as
    ``csrc/lfcc_fused.cu:tc_layout`` computes it: the CSR tables (``fb_words``
    32-bit words, ``KernelOperands.fb_words``); per warpgroup its tile's frame
    buffer (``rows`` rows of ``hop`` samples, each holding its first ``cols`` =
    min(hop, kp) samples, the ones a tap reaches, at ``pitch`` bf16: ``cols``
    or ``cols + 8``, whichever makes pitch/8 odd, so that eight consecutive
    frames fall on eight distinct 16-byte bank groups; hi and at 'high' lo;
    after the products the (64 x n_lfcc) f32 output tile), its f32 power stage
    and its filterbank energies; then the W ring of ``stages`` stages. The
    first that fits 227 KB of: two warpgroups (``warpgroups``) with 3 stages,
    then 2; one warpgroup with 3, then 2. Bytes in all: ``total``. None where
    none fits."""
    planes = 2 if precision == "high" else 1
    kp = K_SLICE * -(-win // K_SLICE)
    cols = min(hop, kp)
    pitch = cols if (cols // 8) % 2 else cols + 8
    rows = TILE_FRAMES + -(-kp // hop) - 1
    plane_bytes = _align128(rows * pitch * 2)
    xs_bytes = _align128(max(planes * plane_bytes, TILE_FRAMES * n_lfcc * 4))
    power_bytes = _align128(TILE_FRAMES * POWER_PITCH * 4)
    energy_bytes = _align128(TILE_FRAMES * (n_filter | 1) * 4)
    stage_bytes = planes * SLICE_ELEMS * 2
    tables = _align128(BARRIER_BYTES + 4 * fb_words)
    for warpgroups in (2, 1):
        for stages in (3, 2):
            total = (tables + warpgroups * (xs_bytes + power_bytes + energy_bytes)
                     + stages * stage_bytes)
            if total <= SMEM_LIMIT:
                return {"cols": cols, "pitch": pitch, "rows": rows,
                        "warpgroups": warpgroups, "stages": stages, "total": total}
    return None


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("lfcc_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lfcc_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
    lib.lfcc_fused_launch.restype = i
    lib.lfcc_fused_config.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.lfcc_fused_config.restype = i
    return lib


CONFIG_KEYS = ("tile_frames", "cta_frames", "smem_bytes", "stages", "threads",
               "ctas_per_sm")


def kernel_config(precision: str = "high", sample_rate: int = 16000, n_fft: int = 512,
                  hop_length: int = 160, win_length: int = 400, n_filter: int = 70,
                  n_lfcc: int = 60, device: int = 0) -> dict:
    """The kernel's launch figures for a shape, read from the library:
    frames a warpgroup tile and a CTA, shared memory a CTA, W ring stages,
    threads, CTAs an SM (the occupancy calculator)."""
    ops = kernel_operands(sample_rate, n_fft, win_length, n_filter, n_lfcc, precision,
                          torch.device("cpu"))
    info = (ctypes.c_int * len(CONFIG_KEYS))()
    rc = _kernel_lib().lfcc_fused_config(MODES[precision], hop_length, win_length,
                                         n_filter, n_lfcc, ops.fb_words, device, info)
    if rc != 0:
        raise RuntimeError(f"lfcc_fused_config failed with CUDA error {rc}")
    return dict(zip(CONFIG_KEYS, info))


class KernelOperands(NamedTuple):
    """The kernel's constant operands (see ``kernel_operands``)."""
    w: torch.Tensor
    fb: torch.Tensor
    fb_index: Optional[torch.Tensor]
    dct: torch.Tensor
    n_chunks: int

    @property
    def fb_words(self) -> int:
        """32-bit words of the CSR tables the kernel copies into shared memory."""
        return 0 if self.fb_index is None else self.fb.numel() + self.fb_index.numel()


def b_operand_index(n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Offset of element (column n, tap k) in a (64 x 80) W slice: the
    no-swizzle K-major core-matrix layout of the kernel's B descriptor (8 x 8
    core matrices of 128 contiguous bytes, LBO 128 B along k, SBO 1280 B
    along n)."""
    return ((n // 8) * (K_SLICE // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8


def filterbank_csr(fb: np.ndarray):
    """(first, last, offset, weights) of each filter's run of bins from its
    first to its last nonzero weight (an empty filter gets first 1, last 0),
    the runs' weights concatenated in filter order."""
    first, last, off, vals = [], [], [], []
    for j in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, j])
        a, z = (int(nz[0]), int(nz[-1])) if nz.size else (1, 0)
        first.append(a)
        last.append(z)
        off.append(len(vals))
        vals.extend(fb[a:z + 1, j].tolist())
    return (np.asarray(first, np.int32), np.asarray(last, np.int32),
            np.asarray(off, np.int32), np.asarray(vals, np.float32))


@functools.lru_cache(maxsize=16)
def kernel_operands(sample_rate: int, n_fft: int, win_length: int, n_filter: int,
                    n_lfcc: int, precision: str, device: torch.device) -> KernelOperands:
    """The kernel's constant operands on ``device``.

    'high' / 'default' (the tensor-core engine): ``w`` (n_chunks * n_slices,
    planes, 64 * 80) bf16, the DFT matrix zero-padded to kp = 80 *
    ceil(win / 80) taps, as stages of chunk c (bins 32c .. 32c+31) and k-slice
    s (taps 80s .. 80s+79), chunk-major, each stage its bf16 hi then (at
    'high') lo slice laid out by ``b_operand_index``, column 2i the re and
    2i + 1 the im of bin 32c + i. n_chunks covers only the bins up to the last
    one with a nonzero filter weight: the bins past it meet zero weights in
    the plain version's filterbank product (only a power that overflowed to
    inf there could tell, as 0 * inf). ``fb`` the CSR weights f32 and
    ``fb_index`` int32 [first (nf), last (nf), offset (nf), first filter
    touching chunk c (n_chunks), one past the last (n_chunks)]. The hi / lo
    split is the plain version's.

    'highest' (the CUDA-core kernel): ``w`` (n_chunks, 16 * ceil(win / 16), 32)
    f32 in chunks of 16 bins (their re columns, then their im columns, zero
    past win and the last bin), ``fb`` the dense filterbank (n_chunks * 16,
    4 * ceil(nf / 4)) f32, ``fb_index`` None.

    ``dct`` (nf, n_lfcc) f32 either way."""
    cre, cim = _dft_matrices(n_fft, win_length)
    n_bins = n_fft // 2 + 1
    fbm = linear_filterbank(sample_rate, n_fft, n_filter)
    dct = torch.from_numpy(dct_matrix(n_filter, n_lfcc)).to(device)
    if precision == "highest":
        n_chunks = -(-n_bins // HIGHEST_CHUNK_BINS)
        kp = 16 * -(-win_length // 16)
        w = np.zeros((n_chunks, kp, 2 * HIGHEST_CHUNK_BINS), np.float32)
        for c in range(n_chunks):
            b0, b1 = c * HIGHEST_CHUNK_BINS, min((c + 1) * HIGHEST_CHUNK_BINS, n_bins)
            w[c, :win_length, :b1 - b0] = cre[:, b0:b1]
            w[c, :win_length, HIGHEST_CHUNK_BINS:HIGHEST_CHUNK_BINS + b1 - b0] = cim[:, b0:b1]
        fb = np.zeros((n_chunks * HIGHEST_CHUNK_BINS, 4 * -(-n_filter // 4)), np.float32)
        fb[:n_bins, :n_filter] = fbm
        return KernelOperands(torch.from_numpy(w).to(device), torch.from_numpy(fb).to(device),
                              None, dct, n_chunks)

    first, last, off, vals = filterbank_csr(fbm)
    top = int(last.max()) if (last >= first).any() else 0
    n_chunks = max(1, -(-(top + 1) // CHUNK_BINS))
    kp = K_SLICE * -(-win_length // K_SLICE)
    n_slices = kp // K_SLICE
    dense = np.zeros((kp, n_chunks * CHUNK_BINS, 2), np.float32)   # (tap, bin, re / im)
    nb = min(n_bins, n_chunks * CHUNK_BINS)
    dense[:win_length, :nb, 0] = cre[:, :nb]
    dense[:win_length, :nb, 1] = cim[:, :nb]
    wt = torch.from_numpy(dense)
    hi = wt.to(torch.bfloat16)
    planes = [hi]
    if precision == "high":
        planes.append((wt - hi.float()).to(torch.bfloat16))
    n = np.arange(2 * CHUNK_BINS)[:, None]
    k = np.arange(K_SLICE)[None, :]
    idx = torch.from_numpy(b_operand_index(n, k).ravel())
    stages = torch.empty((n_chunks, n_slices, len(planes), SLICE_ELEMS), dtype=torch.bfloat16)
    for c in range(n_chunks):
        for s in range(n_slices):
            for p, plane in enumerate(planes):
                # (tap, bin, re / im) -> (column n = 2 * bin + re / im, tap)
                blk = plane[K_SLICE * s:K_SLICE * (s + 1),
                            CHUNK_BINS * c:CHUNK_BINS * (c + 1)].reshape(K_SLICE, -1).T
                stages[c, s, p, idx] = blk.reshape(-1)
    touch = [[j for j in range(n_filter) if first[j] <= last[j]
              and first[j] <= CHUNK_BINS * (c + 1) - 1 and last[j] >= CHUNK_BINS * c]
             for c in range(n_chunks)]
    jlo = np.asarray([t[0] if t else 0 for t in touch], np.int32)
    jhi = np.asarray([t[-1] + 1 if t else 0 for t in touch], np.int32)
    index = np.concatenate([first, last, off, jlo, jhi]).astype(np.int32)
    return KernelOperands(stages.reshape(n_chunks * n_slices, len(planes), SLICE_ELEMS)
                          .to(device), torch.from_numpy(vals).to(device),
                          torch.from_numpy(index).to(device), dct, n_chunks)


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
    ops = kernel_operands(sample_rate, n_fft, win_length, n_filter, n_lfcc, precision,
                          x.device)
    if precision != "highest" and tc_smem_layout(hop_length, win_length, n_filter, n_lfcc,
                                                 precision, ops.fb_words) is None:
        raise ValueError(f"lfcc_fused: hop {hop_length}, win {win_length}, {n_filter} "
                         f"filters and {n_lfcc} coefficients at {precision!r} need more "
                         f"than {SMEM_LIMIT} bytes of shared memory a CTA")
    lib = _kernel_lib()
    n_frames = 1 + (t + 2 * (win_length // 2) - win_length) // hop_length
    out = torch.empty((bsz, n_frames, n_lfcc), dtype=torch.float32, device=x.device)
    dev = x.device
    ptr = lambda v: ctypes.c_void_p(v.data_ptr() if v is not None else 0)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lfcc_fused_launch(
            ptr(x), ptr(ops.w), ptr(ops.fb), ptr(ops.fb_index), ptr(ops.dct), ptr(out),
            bsz, t, hop_length, win_length, ops.n_chunks, n_filter, n_lfcc,
            ops.fb.numel() if ops.fb_index is not None else 0, ctypes.c_float(log_eps),
            MODES[precision], dev.index, ctypes.c_void_p(stream))
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
