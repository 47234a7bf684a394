"""Train-mode BatchNorm + ReLU with a two-pass backward: kernel K2 on Hopper.

Port of ``adfmsl/ops/pallas/bn_relu_bwd.py:bn_relu_train`` (:100), a custom
VJP. Its forward is plain math (adfmsl ``_fwd`` :106-112), and so is the
port's: over (B, T, C) with the statistics over (B, T) in f32,
``mu = E[x]``, ``var = E[x^2] - mu^2``, ``rstd = rsqrt(var + eps)``,
``y = relu(gamma * (x - mu) * rstd + beta)`` in ``x.dtype``; it saves ``x``,
not ``y``. Its backward (adfmsl ``_bwd`` :115-159) is the kernel pair:
``dz`` cast to ``x.dtype``; x^ and the mask ``y > 0`` recomputed from x in
f32; per-tile partials of ``sum(dy * x^)`` and ``sum(dy)``, summed over the
tiles (dgamma, dbeta); ``dx = (gamma * rstd / N) * (N * dy - dbeta - x^ *
dgamma)`` in ``x.dtype``; dgamma and dbeta in gamma's dtype.

``bn_relu_bwd`` launches the CUDA kernels (csrc/bn_relu_bwd.cu) for CUDA
tensors, counting two launches in ``bn_relu_bwd.launches``, and runs the plain
version (``bn_relu_bwd_plain``, the same formula with the same rounding
points) for CPU tensors; any other device raises. As in adfmsl no model wires
it in: the trunk runs BN + ReLU as plain ops, and this op is reached through
its own entry point, ``python -m adfmsl_torch.measure_bn_relu_bwd``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

TILE_ROWS = 512                 # rows per pass-1 block (csrc/bn_relu_bwd.cu)
CHANNELS = (128, 256)           # the trunk widths the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bn_relu_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mu, rstd): adfmsl's ``_fwd`` math, statistics in f32."""
    xf = x.float()
    mu = xf.mean(dim=(0, 1))
    var = (xf * xf).mean(dim=(0, 1)) - mu * mu
    rstd = torch.rsqrt(var + eps)
    y = torch.relu(gamma * (xf - mu) * rstd + beta).to(x.dtype)
    return y, mu, rstd


def bn_relu_bwd_plain(x: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch, with the kernel's rounding points;
    only the order of the f32 sums differs."""
    b, t, c = x.shape
    n = b * t
    x2 = x.reshape(n, c).float()
    dz2 = dz.reshape(n, c).to(x.dtype).float()
    g, bt = gamma.float(), beta.float()
    xhat = (x2 - mu) * rstd
    y = g * xhat + bt
    dy = torch.where(y > 0, dz2, torch.zeros((), device=x.device))
    dgamma = (dy * xhat).sum(dim=0)
    dbeta = dy.sum(dim=0)
    scale = (g * rstd) * (1.0 / n)
    dx = scale * ((n * dy - dbeta) - xhat * dgamma)
    return (dx.to(x.dtype).reshape(b, t, c), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("bn_relu_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_relu_reduce_launch.argtypes = [p, p, p, p, ll, i, i, i, p]
    lib.bn_relu_reduce_launch.restype = i
    lib.bn_relu_dx_launch.argtypes = [p, p, p, p, p, ll, i, i, i, p]
    lib.bn_relu_dx_launch.restype = i
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(x, dz, gamma, beta, mu, rstd):
    if x.dtype not in _DTYPES or x.dim() != 3:
        raise ValueError(f"bn_relu_bwd: x must be (B, T, C) f32 or bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, t, c = x.shape
    if c not in CHANNELS or tuple(dz.shape) != tuple(x.shape):
        raise ValueError(f"bn_relu_bwd: C must be one of {CHANNELS} and dz {tuple(x.shape)}, "
                         f"got C={c}, dz {tuple(dz.shape)}")
    dev = x.device
    vecs = [gamma, beta, mu, rstd]
    if any(v.shape != (c,) or v.device != dev for v in vecs):
        raise ValueError(f"bn_relu_bwd: gamma, beta, mu, rstd must be ({c},) on {dev}")
    x = x.contiguous()
    dz = dz.to(x.dtype).contiguous()                  # adfmsl casts dz to x.dtype (:120)
    if x.data_ptr() % 16 or dz.data_ptr() % 16:
        raise ValueError("bn_relu_bwd: x and dz must be 16-byte aligned")
    n = b * t
    stats = torch.stack([v.float() for v in vecs]).contiguous()      # (4, C)
    tiles = -(-n // TILE_ROWS)
    partials = torch.empty((tiles, 2, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    lib = _kernel_lib()
    code = _DTYPES[x.dtype]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.bn_relu_reduce_launch(_ptr(x), _ptr(dz), _ptr(stats), _ptr(partials),
                                       n, c, code, dev.index, stream)
        if rc != 0:
            raise RuntimeError(f"bn_relu_bwd: pass 1 launch failed with CUDA error {rc}")
        sums = partials.sum(dim=0)                    # (2, C): dgamma, dbeta
        rc = lib.bn_relu_dx_launch(_ptr(x), _ptr(dz), _ptr(stats), _ptr(sums), _ptr(dx),
                                   n, c, code, dev.index, stream)
        if rc != 0:
            raise RuntimeError(f"bn_relu_bwd: pass 2 launch failed with CUDA error {rc}")
    bn_relu_bwd.launches += 2
    return dx, sums[0].to(gamma.dtype), sums[1].to(beta.dtype)


def bn_relu_bwd(x: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of ``relu(BN_train(x))`` for the cotangent ``dz``.

    A CUDA ``x`` launches the K2 kernel pair (and counts two launches in
    ``bn_relu_bwd.launches``) or raises; a CPU ``x`` runs the plain version."""
    if x.device.type == "cuda":
        return _launch(x, dz, gamma, beta, mu, rstd)
    if x.device.type == "cpu":
        return bn_relu_bwd_plain(x, dz, gamma, beta, mu, rstd)
    raise ValueError(f"bn_relu_bwd: unsupported device {x.device}")


bn_relu_bwd.launches = 0


class _BNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mu, rstd = bn_relu_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dz):
        x, gamma, beta, mu, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = bn_relu_bwd(x, dz, gamma, beta, mu, rstd)
        return dx, dgamma, dbeta, None


def bn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """relu(batchnorm_train(x)) over (B, T, C), statistics over (B, T); its
    backward is ``bn_relu_bwd``. No running statistics are kept (adfmsl
    leaves them to the caller)."""
    return _BNReLUTrain.apply(x, gamma, beta, eps)
