"""Train-mode BatchNorm + ReLU with a one-launch backward: kernel K2 on Hopper.

Port of ``adfmsl/ops/pallas/bn_relu_bwd.py:bn_relu_train`` (:100), a custom
VJP. Its forward is plain math (adfmsl ``_fwd`` :106-112), and so is the
port's: over (B, T, C) with the statistics over (B, T) in f32,
``mu = E[x]``, ``var = E[x^2] - mu^2``, ``rstd = rsqrt(var + eps)``,
``y = relu(gamma * (x - mu) * rstd + beta)`` in ``x.dtype``; it saves ``x``,
not ``y``. Its backward (adfmsl ``_bwd`` :115-159, two Pallas kernels) is one
cooperative kernel launch here: ``dz`` cast to ``x.dtype``; x^ and the mask
``y > 0`` recomputed from x in f32; ``sum(dy * x^)`` and ``sum(dy)`` over the
rows (dgamma, dbeta), each CTA's partial summed in CTA order after a grid
barrier; ``dx = (gamma * rstd / N) * (N * dy - dbeta - x^ * dgamma)`` in
``x.dtype``; dgamma and dbeta in gamma's dtype.

``bn_relu_bwd`` launches the CUDA kernel (csrc/bn_relu_bwd.cu) for CUDA
tensors, counting one launch in ``bn_relu_bwd.launches``, and runs the plain
version (``bn_relu_bwd_plain``, the same formula with the same rounding
points) for CPU tensors; any other device raises. ``kernel_config`` is the
kernel's layout (stages, ring, grid, shared memory) from the same formula as
the source. As in adfmsl no model wires it in: the trunk runs BN + ReLU as
plain ops, and this op is reached through its own entry point,
``python -m adfmsl_torch.measure_bn_relu_bwd``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

CHANNELS = (128, 256)           # the trunk widths the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/bn_relu_bwd.cu's constants
CONSUMERS = 512                 # consumer threads a CTA; a producer warp besides
STAGE_BYTES = 32768             # a stage's x rows and the same dz rows
SMEM_LIMIT = 232448             # 227 KB: the most a CTA may take on an H100


def _ctas(n_rows: int, rows_per_stage: int, n_sm: int, ctas_per_sm: int) -> int:
    """CTAs of the launch: all that fit at once, at most one a stage."""
    return min(n_sm * ctas_per_sm, -(-n_rows // rows_per_stage))


def kernel_config(n_rows: int, c: int, dtype: torch.dtype, n_sm: int,
                  ctas_per_sm: int) -> dict:
    """The kernel's layout for ``n_rows`` rows of ``c`` channels, as
    ``csrc/bn_relu_bwd.cu`` computes it: ``rows_per_stage`` (32 KB of x and dz
    together), ``stages`` in the ring (as many as fit beside the (2, row
    groups, C) f32 reduction scratch and two mbarriers a stage), ``ctas`` (at
    most ``n_sm * ctas_per_sm``, the CTAs resident at once, and at most one a
    stage), ``stage_ranges`` (each CTA's [first, end) of the ``n_stages``
    stages, contiguous, the counts differing by at most one), ``smem_bytes``
    a CTA and ``threads`` a CTA."""
    elem = torch.finfo(dtype).bits // 8
    rows = STAGE_BYTES // (2 * c * elem)
    red = 2 * CONSUMERS * (16 // elem) * 4
    stages = (SMEM_LIMIT - red) // (STAGE_BYTES + 16)
    n_stages = -(-n_rows // rows)
    ctas = _ctas(n_rows, rows, n_sm, ctas_per_sm)
    per, extra = divmod(n_stages, ctas)
    ranges = [(b * per + min(b, extra), (b + 1) * per + min(b + 1, extra))
              for b in range(ctas)]
    return {"rows_per_stage": rows, "stages": stages, "n_stages": n_stages,
            "ctas": ctas, "stage_ranges": ranges,
            "smem_bytes": stages * STAGE_BYTES + red + 16 * stages,
            "threads": CONSUMERS + 32}


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
    lib.bn_relu_bwd_query.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.bn_relu_bwd_query.restype = i
    lib.bn_relu_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.bn_relu_bwd_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def card_layout(c: int, dtype: torch.dtype, device_index: int) -> dict:
    """The library's own layout on a card: rows a stage, stages, shared
    memory and threads a CTA (held against ``kernel_config``'s formula, which
    must agree), CTAs an SM (the occupancy calculator) and the SM count."""
    info = (ctypes.c_int * 6)()
    rc = _kernel_lib().bn_relu_bwd_query(c, _DTYPES[dtype], device_index, info)
    if rc != 0:
        raise RuntimeError(f"bn_relu_bwd_query failed with CUDA error {rc}")
    keys = ("rows_per_stage", "stages", "smem_bytes", "threads", "ctas_per_sm", "n_sm")
    got = dict(zip(keys, info))
    want = kernel_config(1, c, dtype, got["n_sm"], got["ctas_per_sm"])
    if any(got[k] != want[k] for k in keys[:4]) or got["ctas_per_sm"] < 1:
        raise RuntimeError(f"bn_relu_bwd: the library's layout {got} is not "
                           f"kernel_config's {want}")
    return got


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
    stats = [v.float().contiguous() for v in vecs]    # no copy for f32 vectors
    lay = card_layout(c, x.dtype, dev.index)
    ctas = _ctas(n, lay["rows_per_stage"], lay["n_sm"], lay["ctas_per_sm"])
    partials = torch.empty((ctas, 2, c), dtype=torch.float32, device=dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)   # dgamma, dbeta
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = _kernel_lib().bn_relu_bwd_launch(
            _ptr(x), _ptr(dz), *(_ptr(v) for v in stats), _ptr(partials), _ptr(sums),
            _ptr(dx), n, c, _DTYPES[x.dtype], ctas, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"bn_relu_bwd: launch failed with CUDA error {rc}")
    bn_relu_bwd.launches += 1
    return dx, sums[0].to(gamma.dtype), sums[1].to(beta.dtype)


def bn_relu_bwd(x: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of ``relu(BN_train(x))`` for the cotangent ``dz``.

    A CUDA ``x`` launches the K2 kernel (and counts one launch in
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
