"""Fused SincConv + |.| + MaxPool3 (the RawNet front end): kernel K3 on Hopper,
and the hand-written backward of its trainable form.

Port of ``adfmsl/ops/pallas/sinc_fused.py:sinc_abs_pool_fused`` (:81). Its
function, with its rounding points (:70-77): x and the filters are rounded to
bf16, the VALID stride-1 correlation over the K taps accumulates in f32, then
``|.|`` and the max over each group of 3 conv outputs; the output is
(B, (T-K+1)//3, C) in f32, the ``T' % 3`` tail dropped.

``sinc_abs_pool_fused`` runs the CUDA kernel (csrc/sinc_abs_pool.cu) for a CUDA
tensor and the plain PyTorch version (``sinc_abs_pool_plain``, the same math
with the same rounding points) for a CPU tensor; anything else raises. The
kernels are built with nvcc at their first call (ops/_build.py).

``sinc_abs_pool`` is the trainable form, the port of adfmsl's custom VJP
(``sinc_fused.py:137-159``): its forward is ``sinc_abs_pool_fused``, and its
backward is the VJP of the f32 composition ``sinc_abs_pool3_nhc`` recomputed at
the saved, unrounded operands (``_sap_bwd`` :152). So the max-pool routes the
gradient by the recompute's maxima, which can differ from the kernel's bf16
max at near-ties (adfmsl :17-23). The filters' gradient is
``sinc_abs_pool_bwd``: a CUDA kernel (csrc/sinc_abs_pool_bwd.cu) for a CUDA
tensor, the plain version ``sinc_abs_pool_bwd_plain`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from adfmsl_torch.ops.sinc import conv_precision, sinc_abs_pool3_nhc, sinc_conv_nhc

MAX_CHANNELS = 256
MAX_TAPS = 256
CHANNEL_TILE = 64                   # channels of one kernel tile (the wgmma N)
PRECISIONS = ("tf32", "3xtf32")     # the backward's recompute and weight-gradient passes
_PASSES = {"tf32": 1, "3xtf32": 3}


def sinc_abs_pool_plain(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch: the operands rounded to bf16, then the
    f32 composition. bf16 products are exact in f32, so only the order of the
    f32 sums differs from the kernel (with TF32 off in cuDNN on the card)."""
    return sinc_abs_pool3_nhc(x.to(torch.bfloat16).float(),
                              filters.to(torch.bfloat16).float())


def sinc_abs_pool_bwd_plain(x: torch.Tensor, filters: torch.Tensor, g: torch.Tensor,
                            precision: str = "3xtf32") -> torch.Tensor:
    """d filters of ``sinc_abs_pool3_nhc(x, filters)`` for the cotangent ``g``
    (B, (T-K+1)//3, C), step by step, under the cuDNN setting of the
    composition the kernel stands in for (``precision`` 'tf32': cuDNN's
    defaults; '3xtf32': exact f32; the CPU is exact f32 either way):

    - z = sinc_conv_nhc(x, filters), (B, T', C);
    - each pool triple's gradient g goes to its maxima of |z|, split evenly
      among tied maxima (the VJP of ``jnp.max`` and of ``amax``);
    - times d|z|/dz as ``jnp.abs`` takes it: +1 where z >= 0 (z = 0 too), -1
      where z < 0, as autograd through the composition takes it
      (``ops/sinc.py:abs_jax``);
    - d filters[c, k] = sum_{b,t} G[b, t, c] * x[b, t + k], as the conv's
      weight gradient (the backward autograd takes)."""
    if precision not in PRECISIONS:
        raise ValueError(f"sinc_abs_pool_bwd: precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    bsz = x.shape[0]
    c, k = filters.shape
    with conv_precision(precision == "3xtf32"):
        z = sinc_conv_nhc(x, filters)
        t3 = z.shape[1] // 3
        zz = z[:, : 3 * t3].reshape(bsz, t3, 3, c)
        mag = zz.abs()
        hit = (mag == mag.amax(dim=2, keepdim=True)).to(g.dtype)
        share = g[:, :, None, :] / hit.sum(dim=2, keepdim=True) * hit
        gz = torch.zeros_like(z)
        slope = torch.where(zz >= 0, 1.0, -1.0).to(g.dtype)
        gz[:, : 3 * t3] = (share * slope).reshape(bsz, 3 * t3, c)
        return torch.nn.grad.conv1d_weight(x[:, None, :], (c, 1, k),
                                           gz.transpose(1, 2))[:, 0, :]


# Twice the worst-case error of the recompute, relative to S = sum_k |x| |f|:
# one TF32 pass rounds both operands at 2^-11 (a product off by at most 2^-10,
# the f32 sum's error far below), three passes leave the f32 sum of up to 256
# terms (at most about 256 * 2^-24 = 2^-16).
ROUTING_DELTA = {"tf32": 2.0 ** -8, "3xtf32": 2.0 ** -15}


def near_tie_mask(x: torch.Tensor, filters: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, T3, C) bool: the pool triples whose routing two correct recomputes at
    ``precision`` may disagree on. With z in f64, a triple is a near-tie where
    the gap between its two largest |z| is below ROUTING_DELTA[precision] * S
    (S the largest sum_k |x| |f| of its three) and above 0: each correct
    recompute's |z| lies within a quarter of that bound of the exact one, so a
    wider gap routes the same way on every side. An exact tie (gap 0: identical windows, as over a constant stretch of
    x) is computed from the same operands in the same order on every side, so it
    ties there too and is checked, not masked."""
    xd, fd = x.double(), filters.double()
    bsz, c = x.shape[0], filters.shape[0]
    z = sinc_conv_nhc(xd, fd)
    t3 = z.shape[1] // 3
    mag = z[:, : 3 * t3].abs().reshape(bsz, t3, 3, c)
    top = mag.topk(2, dim=2).values
    gap = top[:, :, 0] - top[:, :, 1]
    scale = sinc_conv_nhc(xd.abs(), fd.abs())[:, : 3 * t3].reshape(bsz, t3, 3, c).amax(dim=2)
    return (gap > 0) & (gap < ROUTING_DELTA[precision] * scale)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    PTX ``cvt.rna.tf32.f32``, the rounding cuDNN and cuBLAS give TF32 operands."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def kernel_filter_layout(filters: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C, K) filters as the kernels' B operand, one copy: channels zero-padded
    to a multiple of 64 and taps to KP = 16 * ceil(K / 16), then, for each tile
    of 64 channels, the no-swizzle K-major core-matrix layout of a wgmma B
    descriptor: core matrices of 8 channels x 16 bytes of taps (8 bf16 or 4
    TF32), 128 contiguous bytes each, consecutive along the taps (LBO 128 B),
    KP * 16 bytes apart along the channels (SBO). Element (n, k) of a tile sits
    at ((n // 8) * (KP // e) + k // e) * 8e + (n % 8) * e + k % e, e = 8 for
    ``torch.bfloat16`` (K3's forward, rounded to nearest even) and e = 4 for
    ``torch.float32`` (the backward's TF32 operand, rounded by ``tf32_round``).
    Returns a flat (ceil(C / 64) * 64 * KP,) tensor of ``dtype``."""
    if dtype == torch.bfloat16:
        e = 8
    elif dtype == torch.float32:
        e = 4
    else:
        raise ValueError(f"kernel_filter_layout: dtype must be bfloat16 or float32, "
                         f"got {dtype}")
    c, k = filters.shape
    cp = -(-c // CHANNEL_TILE) * CHANNEL_TILE
    kp = -(-k // 16) * 16
    padded = torch.zeros((cp, kp), dtype=torch.float32, device=filters.device)
    padded[:c, :k] = filters
    if dtype == torch.float32:
        padded = tf32_round(padded)
    t = padded.reshape(cp // CHANNEL_TILE, 8, 8, kp // e, e).permute(0, 1, 3, 2, 4)
    out = torch.empty(t.shape, dtype=dtype, device=filters.device)
    return out.copy_(t).reshape(-1)


def _check_operands(name: str, x: torch.Tensor, filters: torch.Tensor) -> None:
    """The shapes and types both kernels take; raises before any build."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, T) f32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (filters.dtype != torch.float32 or filters.dim() != 2
            or filters.device != x.device):
        raise ValueError(f"{name}: filters must be a (C, K) f32 tensor "
                         f"on {x.device}, got {filters.dtype} {tuple(filters.shape)} "
                         f"on {filters.device}")
    t = x.shape[1]
    c, k = filters.shape
    if c % 16 or not 0 < c <= MAX_CHANNELS or not 0 < k <= MAX_TAPS:
        raise ValueError(f"{name}: {c} channels (a multiple of 16, at "
                         f"most {MAX_CHANNELS}) and {k} taps (at most {MAX_TAPS})")
    if t - k + 1 < 3:
        raise ValueError(f"{name}: T={t} leaves no pooled row at K={k}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("sinc_abs_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sinc_abs_pool_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.sinc_abs_pool_launch.restype = i
    return lib


def _launch(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    _check_operands("sinc_abs_pool_fused", x, filters)
    bsz, t = x.shape
    c, k = filters.shape
    w = kernel_filter_layout(filters, torch.bfloat16)
    lib = _kernel_lib()
    out = torch.empty((bsz, (t - k + 1) // 3, c), dtype=torch.float32, device=x.device)
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sinc_abs_pool_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), bsz, t, c, k, dev.index,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sinc_abs_pool_fused: kernel launch failed with CUDA error {rc}")
    sinc_abs_pool_fused.launches += 1
    return out


def sinc_abs_pool_fused(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """(B, T) f32 waveform x (C, K) f32 filters -> (B, (T-K+1)//3, C) f32.

    A CUDA ``x`` launches the K3 kernel (and counts the launch in
    ``sinc_abs_pool_fused.launches``) or raises; a CPU ``x`` runs the plain
    version."""
    if x.device.type == "cuda":
        return _launch(x, filters)
    if x.device.type == "cpu":
        return sinc_abs_pool_plain(x, filters)
    raise ValueError(f"sinc_abs_pool_fused: unsupported device {x.device}")


sinc_abs_pool_fused.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("sinc_abs_pool_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sinc_abs_pool_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.sinc_abs_pool_bwd_launch.restype = i
    lib.sinc_abs_pool_bwd_config.argtypes = [i, i, i, i, i, i, p]
    lib.sinc_abs_pool_bwd_config.restype = i
    return lib


BWD_CONFIG_KEYS = ("ctas_per_channel_tile", "smem_bytes", "threads", "ctas_per_sm",
                   "pooled_rows_per_tile", "dw_taps", "partial_slots")


def bwd_kernel_config(bsz: int, t: int, c: int, k: int, precision: str,
                      device: int = 0) -> dict:
    """The backward kernel's figures for one call on CUDA device ``device``:
    persistent CTAs per 64-channel tile, shared memory a CTA, threads a CTA,
    CTAs an SM (the CUDA occupancy calculator), pooled rows a tile, the taps of
    a d filters partial and the partials a CTA writes (one per 4 tiles)."""
    return dict(zip(BWD_CONFIG_KEYS, _bwd_config(bsz, t, c, k, _PASSES[precision], device)))


@functools.lru_cache(maxsize=None)
def _bwd_config(bsz, t, c, k, passes, device):
    info = (ctypes.c_int * len(BWD_CONFIG_KEYS))()
    rc = _bwd_lib().sinc_abs_pool_bwd_config(bsz, t, c, k, passes, device, info)
    if rc != 0:
        raise RuntimeError(f"sinc_abs_pool_bwd_config failed with CUDA error {rc}")
    return tuple(info)


def _bwd_launch(x: torch.Tensor, filters: torch.Tensor, g: torch.Tensor,
                precision: str) -> torch.Tensor:
    _check_operands("sinc_abs_pool_bwd", x, filters)
    if precision not in PRECISIONS:
        raise ValueError(f"sinc_abs_pool_bwd: precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    bsz, t = x.shape
    c, k = filters.shape
    t3 = (t - k + 1) // 3
    if (g.dtype != torch.float32 or tuple(g.shape) != (bsz, t3, c)
            or g.device != x.device):
        raise ValueError(f"sinc_abs_pool_bwd: g must be a ({bsz}, {t3}, {c}) f32 tensor "
                         f"on {x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    passes = _PASSES[precision]
    w = kernel_filter_layout(filters, torch.float32)
    if passes == 3:            # the filters' TF32 remainder, in the same layout
        w = torch.stack([w, kernel_filter_layout(filters - tf32_round(filters),
                                                 torch.float32)])
        w = w.reshape(2, -1, CHANNEL_TILE * (-(-k // 16) * 16)).transpose(0, 1).contiguous()
    dev = x.device
    cfg = bwd_kernel_config(bsz, t, c, k, precision, dev.index)
    n_ct = -(-c // CHANNEL_TILE)
    partial = torch.empty((n_ct, cfg["partial_slots"], cfg["ctas_per_channel_tile"],
                           cfg["dw_taps"], CHANNEL_TILE), dtype=torch.float32, device=dev)
    dw = torch.empty((c, k), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sinc_abs_pool_bwd_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(dw.data_ptr()), bsz, t, c, k, passes,
            cfg["ctas_per_channel_tile"], dev.index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sinc_abs_pool_bwd: kernel launch failed with CUDA error {rc}")
    sinc_abs_pool_bwd.launches += 1
    return dw


def sinc_abs_pool_bwd(x: torch.Tensor, filters: torch.Tensor, g: torch.Tensor,
                      precision: str) -> torch.Tensor:
    """d filters (C, K) f32 of ``sinc_abs_pool3_nhc(x, filters)`` for the
    cotangent ``g`` (B, (T-K+1)//3, C) f32, at ``precision`` 'tf32' (one TF32
    pass for the recompute and for the weight gradient) or '3xtf32' (three:
    big*big + big*small + small*big, f32 accuracy).

    A CUDA ``x`` launches the backward kernel (and counts the launch in
    ``sinc_abs_pool_bwd.launches``) or raises; a CPU ``x`` runs the plain
    version."""
    if x.device.type == "cuda":
        return _bwd_launch(x, filters, g, precision)
    if x.device.type == "cpu":
        return sinc_abs_pool_bwd_plain(x, filters, g, precision)
    raise ValueError(f"sinc_abs_pool_bwd: unsupported device {x.device}")


sinc_abs_pool_bwd.launches = 0


class _SincAbsPool(torch.autograd.Function):
    """K3 forward; the backward kernel for d filters."""

    @staticmethod
    def forward(ctx, x, filters, exact_fp32):
        ctx.save_for_backward(x, filters)
        ctx.exact_fp32 = exact_fp32
        return sinc_abs_pool_fused(x, filters)

    @staticmethod
    def backward(ctx, g):
        x, filters = ctx.saved_tensors
        need_x, need_f = ctx.needs_input_grad[:2]
        dx = df = None
        if need_f:
            # the precision of the composition this stands in for: one TF32
            # pass where its cuDNN conv would take TF32, f32 accuracy otherwise
            tf32 = not ctx.exact_fp32 and torch.backends.cudnn.allow_tf32
            df = sinc_abs_pool_bwd(x, filters.detach(), g.float(),
                                   "tf32" if tf32 else "3xtf32")
        if need_x:
            # d x stays the composition's VJP on every device: no model path
            # asks for it (the waveform is data), no TPU kernel computes it,
            # and adfmsl takes it from the same XLA VJP (sinc_fused.py:152)
            with torch.enable_grad(), conv_precision(ctx.exact_fp32):
                xr = x.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(sinc_abs_pool3_nhc(xr, filters.detach()),
                                            (xr,), g)
        return dx, df, None


def sinc_abs_pool(x: torch.Tensor, filters: torch.Tensor,
                  exact_fp32: bool = False) -> torch.Tensor:
    """The trainable fused front end: ``sinc_abs_pool_fused(x, filters)``
    forward, differentiable in ``filters`` through ``sinc_abs_pool_bwd`` (the
    recompute's routing and weight gradient; TF32 where the composition's
    cuDNN conv would take TF32, i.e. without ``exact_fp32`` and with
    ``torch.backends.cudnn.allow_tf32``, else f32 accuracy), and in ``x``
    where it requires a gradient through the f32 composition's VJP.
    ``x`` (B, T) f32, ``filters`` (C, K) f32."""
    return _SincAbsPool.apply(x.contiguous(), filters, exact_fp32)
