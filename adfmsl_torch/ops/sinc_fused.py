"""Fused SincConv + |.| + MaxPool3 (the RawNet front end): kernel K3 on Hopper.

Port of ``adfmsl/ops/pallas/sinc_fused.py:sinc_abs_pool_fused`` (:81). Its
function, with its rounding points (:70-77): x and the filters are rounded to
bf16, the VALID stride-1 correlation over the K taps accumulates in f32, then
``|.|`` and the max over each group of 3 conv outputs; the output is
(B, (T-K+1)//3, C) in f32, the ``T' % 3`` tail dropped.

``sinc_abs_pool_fused`` runs the CUDA kernel (csrc/sinc_abs_pool.cu) for a CUDA
tensor and the plain PyTorch version (``sinc_abs_pool_plain``, the same math
with the same rounding points) for a CPU tensor; anything else raises. The
kernel is built with nvcc at its first call (ops/_build.py).

``sinc_abs_pool`` is the trainable form, the port of adfmsl's custom VJP
(``sinc_fused.py:137-159``): its forward is ``sinc_abs_pool_fused``, and its
backward recomputes the f32 composition ``sinc_abs_pool3_nhc`` at the saved,
unrounded operands and takes its VJP (``_sap_bwd`` :152). So the max-pool
routes the gradient by the f32 recompute's argmax, which can differ from the
kernel's bf16 max at near-ties (adfmsl :17-23). The backward is no kernel in
adfmsl and none here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from adfmsl_torch.ops.sinc import conv_precision, sinc_abs_pool3_nhc

MAX_CHANNELS = 256
MAX_TAPS = 256


def sinc_abs_pool_plain(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch: the operands rounded to bf16, then the
    f32 composition. bf16 products are exact in f32, so only the order of the
    f32 sums differs from the kernel (with TF32 off in cuDNN on the card)."""
    return sinc_abs_pool3_nhc(x.to(torch.bfloat16).float(),
                              filters.to(torch.bfloat16).float())


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("sinc_abs_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sinc_abs_pool_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.sinc_abs_pool_launch.restype = i
    return lib


def _launch(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("sinc_abs_pool_fused: x must be a contiguous (B, T) f32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (filters.dtype != torch.float32 or filters.dim() != 2
            or filters.device != x.device):
        raise ValueError("sinc_abs_pool_fused: filters must be a (C, K) f32 tensor "
                         f"on {x.device}, got {filters.dtype} {tuple(filters.shape)} "
                         f"on {filters.device}")
    bsz, t = x.shape
    c, k = filters.shape
    if c % 16 or not 0 < c <= MAX_CHANNELS or not 0 < k <= MAX_TAPS:
        raise ValueError(f"sinc_abs_pool_fused: {c} channels (a multiple of 16, at "
                         f"most {MAX_CHANNELS}) and {k} taps (at most {MAX_TAPS})")
    if t - k + 1 < 3:
        raise ValueError(f"sinc_abs_pool_fused: T={t} leaves no pooled row at K={k}")
    filters = filters.contiguous()
    lib = _kernel_lib()
    out = torch.empty((bsz, (t - k + 1) // 3, c), dtype=torch.float32, device=x.device)
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sinc_abs_pool_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(filters.data_ptr()),
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


class _SincAbsPool(torch.autograd.Function):
    """K3 forward, backward through the f32 composition's recompute."""

    @staticmethod
    def forward(ctx, x, filters, exact_fp32):
        ctx.save_for_backward(x, filters)
        ctx.exact_fp32 = exact_fp32
        return sinc_abs_pool_fused(x, filters)

    @staticmethod
    def backward(ctx, g):
        x, filters = ctx.saved_tensors
        need_x, need_f = ctx.needs_input_grad[:2]
        with torch.enable_grad(), conv_precision(ctx.exact_fp32):
            xr = x.detach().requires_grad_(need_x)
            fr = filters.detach().requires_grad_(need_f)
            wrt = [t for t in (xr, fr) if t.requires_grad]
            grads = iter(torch.autograd.grad(sinc_abs_pool3_nhc(xr, fr), wrt, g))
        return (next(grads) if need_x else None, next(grads) if need_f else None, None)


def sinc_abs_pool(x: torch.Tensor, filters: torch.Tensor,
                  exact_fp32: bool = False) -> torch.Tensor:
    """The trainable fused front end: ``sinc_abs_pool_fused(x, filters)``
    forward, differentiable in ``filters`` (and in ``x`` where it requires a
    gradient) through the f32 composition recomputed in the backward under
    ``conv_precision(exact_fp32)``, the setting of the composition it stands
    in for. ``x`` (B, T) f32, ``filters`` (C, K) f32."""
    return _SincAbsPool.apply(x.contiguous(), filters, exact_fp32)
