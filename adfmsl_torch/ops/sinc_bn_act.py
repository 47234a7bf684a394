"""Kernel K5: the sinc front end of the maze4 / maze5 models at eval (the TF32
filterbank conv, then first_bn from its running statistics and SELU) in one
Hopper kernel that writes the trunk's bf16 input.

K5 replaces no TPU kernel: adfmsl leaves this front end to XLA. It is the
port's own, for the composition that ``models/mazes.py:_frontend`` runs at eval
in a bf16 model: ``sinc_conv_nhc`` in cuDNN's TF32, ``.to(bf16)``, the eval
BatchNorm's f32 affine (``ops/norm.py:affine``) cast to bf16, and ``F.selu`` on
that bf16 tensor. Its function, with those rounding points (csrc/sinc_bn_act.cu
states them per element): (B, T) f32 waveform x (C, K) f32 filters and the
BatchNorm's (C,) f32 operands (mean, mul, bias) (``ops/norm.py:eval_affine``)
-> contiguous (B, T-K+1, C) bf16.

``sinc_bn_act_fused`` runs the CUDA kernel for a CUDA tensor (and counts the
call in the ``sinc.fused_bn_act`` counter of ``utils/profiling.py``) and the
plain version ``sinc_bn_act_plain`` (the composition itself) for a CPU tensor;
anything else raises. The kernel is built with nvcc at its first call
(ops/_build.py).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from adfmsl_torch.ops.norm import affine
from adfmsl_torch.ops.sinc import sinc_conv_nhc
from adfmsl_torch.ops.sinc_fused import kernel_filter_layout
from adfmsl_torch.utils.profiling import count

MAX_CHANNELS = 256
MAX_TAPS = 256
CHANNEL_TILE = 128                  # channels of one kernel tile (the wgmma N)
TAP_STEP = 32                       # taps of one group of the kernel's k-steps
# SELU's coefficients as torch's elu kernel takes them: scale, and alpha * scale
# multiplied in f32 (at::selu's double constants cast to f32 first); the kernel
# takes y * SELU_POS for y >= +0, and SELU_NEG is SELU's steepest slope
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946
SELU_POS = float(np.float32(_SELU_SCALE))
SELU_NEG = float(np.float32(_SELU_ALPHA) * np.float32(_SELU_SCALE))
# SELU of a negative bf16 as a table, by its magnitude bits up to those of 8.0:
# at or below -8, expm1 is within 2^-11 of -1, so every output rounds to the
# same bf16, -1.7578125 (SELU_NEG is 1.7581). Padded to 16 bytes (the kernel's
# LUT_BYTES).
SELU_TABLE_LAST = 0x4100
SELU_TABLE_SIZE = 16648


def takes(c: int, k: int) -> bool:
    """Whether K5 takes ``c`` filters of ``k`` taps."""
    return c % 16 == 0 and 0 < c <= MAX_CHANNELS and 0 < k <= MAX_TAPS


def sinc_bn_act_plain(x: torch.Tensor, filters: torch.Tensor, mean: torch.Tensor,
                      mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K5's function in plain PyTorch: the composition of the eval front end,
    step for step (the conv as the device runs it: exact f32 on the CPU, cuDNN's
    TF32 on a card by default)."""
    z = sinc_conv_nhc(x, filters).to(torch.bfloat16)
    return F.selu(affine(z, mean, mul, bias, torch.bfloat16)).contiguous()


# The gap between two correct TF32 computations of the conv, relative to
# S = sum_k |x| |f|: each side's operands are rounded to TF32 (at most 2^-10
# relative if truncated, 2^-11 if rounded, so a product is off by at most
# 2^-9) and its f32 sums of up to 256 terms round at most 256 * 2^-23 = 2^-15;
# two sides, and 1 % for the second-order terms.
CONV_DELTA = 2 * (2.0 ** -9 + 2.0 ** -15) * 1.01


def composition_gap(out: torch.Tensor, x: torch.Tensor, filters: torch.Tensor,
                    mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                    rows: int = 8) -> dict:
    """``out`` (K5's (B, T', C) bf16) against the composition on the same
    device, element by element, ``rows`` batch rows at a time. Each element's
    bound carries the conv's gap (CONV_DELTA * S, S from f64) through the
    composition's steps: a bf16 rounding of two values a and b moves their gap
    by at most 2^-8 (|a| + |b|); the f32 affine scales it by |mul| and rounds
    three times on each side (2^-21 of its operands); SELU's slope is at most
    alpha * scale (SELU_NEG) and its f32 evaluation rounds at 2^-21.
    Returns the largest gap over its bound (at most 1 when K5 is right), the
    largest gap and the share of elements equal bit for bit."""
    h = 2.0 ** -8
    worst = biggest = 0.0
    equal = 0
    m, u, b = (t.double()[None, None, :] for t in (mean, mul, bias))
    for i in range(0, x.shape[0], rows):
        xs = x[i:i + rows]
        s = sinc_conv_nhc(xs.double().abs(), filters.double().abs())
        zc = sinc_conv_nhc(xs, filters)
        zb = zc.to(torch.bfloat16)
        yc = affine(zb, mean, mul, bias, torch.float32)
        yb = yc.to(torch.bfloat16)
        sc = F.selu(yb.float()).double()
        got = out[i:i + rows].double()
        gap = (got - F.selu(yb).double()).abs()
        zc = zc.double().abs()
        d = CONV_DELTA * s
        d = d + h * (2 * zc + d)                                    # bf16(z)
        d = u.abs() * d + 2.0 ** -21 * ((zc * (1 + h) + d + m.abs()) * u.abs() + b.abs())
        d = d + h * (2 * yc.double().abs() + d)                     # bf16(y)
        d = SELU_NEG * d
        d = d + 2.0 ** -21 * (sc.abs() + d)                         # SELU in f32
        d = d + h * (2 * sc.abs() + d)                              # bf16(out)
        ratio = torch.where(gap == 0, 0.0, gap / d).nan_to_num(nan=float("inf"))
        worst = max(worst, float(ratio.max()))
        biggest = max(biggest, float(gap.max()))
        equal += int((gap == 0).sum())
    return {"max_gap_over_bound": worst, "max_abs_gap": biggest,
            "equal_share": equal / out.numel()}


@functools.lru_cache(maxsize=None)
def selu_table(device: torch.device) -> torch.Tensor:
    """(SELU_TABLE_SIZE,) int16 on ``device``: entry i is the bf16 bits of
    ``F.selu`` of the negative bf16 whose magnitude bits are i (i <=
    SELU_TABLE_LAST; the rest 0), computed once by torch's own kernel on that
    device, so K5's SELU is torch's bit for bit."""
    mags = torch.arange(SELU_TABLE_LAST + 1, dtype=torch.int32, device=device)
    y = (mags - 0x8000).to(torch.int16).view(torch.bfloat16)      # sign bit set
    table = torch.zeros(SELU_TABLE_SIZE, dtype=torch.int16, device=device)
    table[:SELU_TABLE_LAST + 1] = F.selu(y).view(torch.int16)
    return table


def kernel_filters(filters: torch.Tensor) -> torch.Tensor:
    """(C, K) f32 filters as K5's B operand: zero-padded to a multiple of 128
    channels and of 32 taps, in ``kernel_filter_layout``'s TF32 core-matrix
    form (rounded by ``tf32_round``)."""
    c, k = filters.shape
    padded = filters.new_zeros((-(-c // CHANNEL_TILE) * CHANNEL_TILE,
                                -(-k // TAP_STEP) * TAP_STEP))
    padded[:c, :k] = filters
    return kernel_filter_layout(padded, torch.float32)


def _check_operands(x: torch.Tensor, filters: torch.Tensor,
                    *bn: torch.Tensor) -> None:
    """The shapes and types the kernel takes; raises before any build."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"sinc_bn_act_fused: x must be a contiguous (B, T) f32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if (filters.dtype != torch.float32 or filters.dim() != 2
            or filters.device != x.device):
        raise ValueError(f"sinc_bn_act_fused: filters must be a (C, K) f32 tensor on "
                         f"{x.device}, got {filters.dtype} {tuple(filters.shape)} on "
                         f"{filters.device}")
    c, k = filters.shape
    if not takes(c, k):
        raise ValueError(f"sinc_bn_act_fused: {c} channels (a multiple of 16, at most "
                         f"{MAX_CHANNELS}) and {k} taps (at most {MAX_TAPS})")
    if x.shape[1] < k:
        raise ValueError(f"sinc_bn_act_fused: T={x.shape[1]} leaves no conv row at K={k}")
    for name, t in zip(("mean", "mul", "bias"), bn):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"sinc_bn_act_fused: {name} must be a contiguous ({c},) f32 "
                             f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("sinc_bn_act")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sinc_bn_act_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.sinc_bn_act_launch.restype = i
    return lib


def _launch(x: torch.Tensor, filters: torch.Tensor, mean: torch.Tensor,
            mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check_operands(x, filters, mean, mul, bias)
    bsz, t = x.shape
    c, k = filters.shape
    w = kernel_filters(filters)
    lib = _kernel_lib()
    out = torch.empty((bsz, t - k + 1, c), dtype=torch.bfloat16, device=x.device)
    dev = x.device
    with torch.cuda.device(dev):
        lut = selu_table(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sinc_bn_act_launch(
            *(ctypes.c_void_p(v.data_ptr()) for v in (x, w, mean, mul, bias, lut, out)),
            bsz, t, c, k, SELU_POS, dev.index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sinc_bn_act_fused: kernel launch failed with CUDA error {rc}")
    count("sinc.fused_bn_act")
    return out


def sinc_bn_act_fused(x: torch.Tensor, filters: torch.Tensor, mean: torch.Tensor,
                      mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, T) f32 waveform x (C, K) f32 filters, with the eval BatchNorm's (C,)
    f32 ``mean``, ``mul`` and ``bias`` -> SELU of the BatchNorm of the conv,
    contiguous (B, T-K+1, C) bf16.

    A CUDA ``x`` launches the K5 kernel (counted in ``sinc.fused_bn_act``) or
    raises; a CPU ``x`` runs the plain version."""
    if x.device.type == "cuda":
        return _launch(x, filters, mean, mul, bias)
    if x.device.type == "cpu":
        return sinc_bn_act_plain(x, filters, mean, mul, bias)
    raise ValueError(f"sinc_bn_act_fused: unsupported device {x.device}")
