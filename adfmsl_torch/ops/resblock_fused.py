"""Folded eval-mode residual-block body: kernel K1 on Hopper.

Port of ``adfmsl/ops/pallas/resblock_fused.py`` (``resblock_eval_fused`` :141,
``fold_block_params`` :220). At eval the 'tpu' ResBlockSE body is, with its
BatchNorm running stats folded into per-channel affines,

    h   = act(x*a1 + c1)                 (h = x at the stack head)
    y1  = act(conv3(h)*w1 + b1)          (bn2 folded into w1, b1)
    out = conv3(y1)*w2 + bt + skip(x)    (identity, or a 1x1 conv)
    y   = out, or VALID MaxPool3(out)    (pool 3: the RawNet block)

plus the exact f32 per-channel sums of the valid rows of y, which feed the SE
(or RawNet FC-attention) gate. Both convs use SAME zero padding applied
*after* the activations, and the rounding points are fixed: h and y1 are
rounded to bf16, the convs take bf16 operands and accumulate in f32, out is
f32, the sums and the pool act on the f32 out, and y is out rounded to bf16.

``resblock_eval`` runs the CUDA kernel (csrc/resblock_eval.cu) for a CUDA
tensor and the plain PyTorch version (``resblock_eval_plain``, the same math
with the same rounding points) for a CPU tensor; anything else raises. The
kernel is built with nvcc at its first call (ops/_build.py). It takes the
(Cin, Cout, skip) of the models' blocks: (128, 128, identity), (128, 256, 1x1)
and (256, 256, identity), and the wide stack heads of maze2 and maze6,
(768, 128, 1x1) and (1024, 128, 1x1), which it takes without ``pre`` (a stack
head has no bn1) and without the pool; and its weights in the slice layout
that ``kernel_weight_layout`` makes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from adfmsl_torch.ops.sinc import max_pool3_nhc

_ACTS = {"relu": 0, "leaky": 1}
# (Cin, Cout, 1x1 skip) the kernel is instantiated for
KERNEL_SHAPES = ((128, 128, False), (128, 256, True), (256, 256, False),
                 (768, 128, True), (1024, 128, True))
# the wide stack heads among them: pre None and pool 1 only
HEAD_ONLY_SHAPES = ((768, 128, True), (1024, 128, True))
SLICE_K = 64                        # k depth of one weight slice


def fold_block_params(t: Mapping[str, torch.Tensor], *, first: bool,
                      eps: float = 1e-5):
    """Fold a 'tpu' ResBlockSE's BatchNorm running stats into K1's operands.

    ``t`` maps the block's own state-dict names ('conv1.weight', 'bn2.running_var',
    ...; torch layout) to tensors. Returns (pre, w1, b1, w2, bt, skw) in f32 and
    in adfmsl's layout: pre (2, Cin) = [a1; c1] or None at the stack head,
    w1 (3, Cin, Cout), b1 (Cout,), w2 (3, Cout, Cout), bt (Cout,) carrying
    conv2's and the 1x1 skip's biases, skw (Cin, Cout) or None."""
    def f(k):
        return t[k].float()

    a2 = f("bn2.weight") * torch.rsqrt(f("bn2.running_var") + eps)
    c2 = f("bn2.bias") - f("bn2.running_mean") * a2
    w1 = f("conv1.weight").permute(2, 1, 0) * a2[None, None, :]
    b1 = f("conv1.bias") * a2 + c2
    pre = None
    if not first:
        a1 = f("bn1.weight") * torch.rsqrt(f("bn1.running_var") + eps)
        c1 = f("bn1.bias") - f("bn1.running_mean") * a1
        pre = torch.stack([a1, c1])
    w2 = f("conv2.weight").permute(2, 1, 0)
    bt = f("conv2.bias")
    skw = None
    if "downsample.weight" in t:
        skw = f("downsample.weight")[:, :, 0].T              # (Cin, Cout)
        bt = bt + f("downsample.bias")
    return pre, w1.contiguous(), b1, w2.contiguous(), bt, skw


def kernel_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """A (taps, K, N) or (K, N) weight in bf16, laid out as the kernel's producer
    streams it: (tap, 64-deep k-chunk) slices in that order, each slice N x 64
    in the no-swizzle K-major layout of a wgmma B descriptor, 8 x 8 core
    matrices of 128 contiguous bytes: element (n, k) of a slice at
    ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8. Flat, contiguous."""
    if w.dim() == 2:
        w = w[None]
    taps, k, n = w.shape
    if k % SLICE_K or n % 8:
        raise ValueError(f"kernel_weight_layout: K {k} must be a multiple of "
                         f"{SLICE_K} and N {n} of 8")
    t = w.reshape(taps, k // SLICE_K, 8, 8, n // 8, 8).permute(0, 1, 4, 2, 5, 3)
    out = torch.empty(t.shape, dtype=torch.bfloat16, device=w.device)  # (d, kc, nb, kb, nlo, klo)
    return out.copy_(t).reshape(-1)              # one copy: rounds to bf16 and lays out


def _act(v: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(v, 0.0)
    if act == "leaky":                                   # LeakyReLU(0.3)
        return torch.maximum(v, 0.3 * v)
    raise ValueError(f"unknown act {act!r}")


def resblock_eval_plain(x, pre, w1, b1, w2, bt, skw, act: str = "relu",
                        pool: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch, with the kernel's rounding points:
    (B, T, Cin) -> (y bf16 (B, T//pool, Cout), sums f32 (B, Cout))."""
    bf = torch.bfloat16
    xb = x.to(bf)
    x32 = xb.float()
    h = x32
    if pre is not None:
        h = _act(x32 * pre[0].float() + pre[1].float(), act)
    h = h.to(bf).float().transpose(1, 2)                          # (B, Cin, T)
    w1k = w1.to(bf).float().permute(2, 1, 0)                      # (Cout, Cin, 3)
    y1 = _act(F.conv1d(h, w1k, padding=1) + b1.float()[:, None], act)
    y1 = y1.to(bf).float()
    out = F.conv1d(y1, w2.to(bf).float().permute(2, 1, 0), padding=1)
    out = out + bt.float()[:, None]
    if skw is None:
        out = out + x32.transpose(1, 2)
    else:
        out = out + (x32 @ skw.to(bf).float()).transpose(1, 2)
    out = out.transpose(1, 2)                                     # (B, T, Cout)
    if pool == 3:
        out = max_pool3_nhc(out)
    elif pool != 1:
        raise ValueError(f"pool must be 1 or 3, got {pool}")
    return out.to(bf), out.sum(dim=1)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("resblock_eval")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resblock_eval_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, i, p]
    lib.resblock_eval_launch.restype = i
    lib.resblock_eval_rows.argtypes = [i, i, i]
    lib.resblock_eval_rows.restype = i
    lib.resblock_eval_config.argtypes = [i, i, i, i, p]
    lib.resblock_eval_config.restype = i
    return lib


def kernel_config(cin: int, cout: int, skip: bool, device: int = 0) -> dict:
    """The kernel's figures for one instantiation on CUDA device ``device``:
    rows a tile, shared memory a CTA, threads a CTA, CTAs an SM (the CUDA
    occupancy calculator), weight bytes a tile and weight-ring stages."""
    info = (ctypes.c_int * 6)()
    rc = _kernel_lib().resblock_eval_config(cin, cout, int(skip), device, info)
    if rc != 0:
        raise RuntimeError(f"resblock_eval_config({cin}, {cout}, {skip}) failed "
                           f"with CUDA error {rc}")
    keys = ("rows", "smem_bytes", "threads", "ctas_per_sm", "weight_bytes_per_tile",
            "stages")
    return dict(zip(keys, info))


def _ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"resblock_eval: {name} is on {t.device}, x on {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"resblock_eval: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _launch(x, pre, w1, b1, w2, bt, skw, act, pool):
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resblock_eval: x must be a contiguous (B, T, Cin) "
                         f"bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    bsz, tin, cin = x.shape
    cout = w1.shape[-1]
    if (cin, cout, skw is not None) not in KERNEL_SHAPES:
        raise ValueError(f"resblock_eval: the kernel takes (Cin, Cout, 1x1 skip) in "
                         f"{KERNEL_SHAPES}, got ({cin}, {cout}, {skw is not None})")
    if act not in _ACTS or pool not in (1, 3) or tin < pool or bsz > 65535:
        raise ValueError(f"resblock_eval: act={act!r} pool={pool} T={tin}")
    if (cin, cout, skw is not None) in HEAD_ONLY_SHAPES and (pre is not None or pool != 1):
        raise ValueError(f"resblock_eval: the kernel takes ({cin}, {cout}) at the stack "
                         "head only (pre None, pool 1)")
    dev = x.device
    _check("w1", w1, (3, cin, cout), dev)
    _check("w2", w2, (3, cout, cout), dev)
    _check("b1", b1, (cout,), dev)
    _check("bt", bt, (cout,), dev)
    if pre is not None:
        _check("pre", pre, (2, cin), dev)
        pre = pre.float().contiguous()
    if skw is not None:
        _check("skw", skw, (cin, cout), dev)
        skw = kernel_weight_layout(skw)
    w1 = kernel_weight_layout(w1)
    w2 = kernel_weight_layout(w2)
    b1 = b1.float().contiguous()
    bt = bt.float().contiguous()
    if x.data_ptr() % 16:                # the bulk copy moves 16-byte aligned rows
        raise ValueError("resblock_eval: x is not 16-byte aligned")

    lib = _kernel_lib()
    n_tiles = -(-tin // lib.resblock_eval_rows(cin, cout, int(skw is not None)))
    y = torch.empty((bsz, tin // pool, cout), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((bsz, n_tiles, cout), dtype=torch.float32, device=dev)
    sums = torch.empty((bsz, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.resblock_eval_launch(
            _ptr(x), _ptr(pre), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(bt), _ptr(skw),
            _ptr(y), _ptr(partial), _ptr(sums), bsz, tin, cin, cout,
            _ACTS[act], pool, dev.index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"resblock_eval: kernel launch failed with CUDA error {rc}")
    resblock_eval.launches += 1
    return y, sums


def resblock_eval(x, pre, w1, b1, w2, bt, skw, act: str = "relu",
                  pool: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One folded eval block body: (B, T, Cin) bf16 -> (y bf16 (B, T//pool,
    Cout), sums f32 (B, Cout)). Operands as ``fold_block_params`` returns them
    (f32 weights are rounded to bf16 here, as the Pallas wrapper does, and laid
    out for the kernel by ``kernel_weight_layout``, every call).

    A CUDA ``x`` launches the K1 kernel (and counts the launch in
    ``resblock_eval.launches``) or raises; a CPU ``x`` runs the plain version."""
    if x.device.type == "cuda":
        return _launch(x, pre, w1, b1, w2, bt, skw, act, pool)
    if x.device.type == "cpu":
        return resblock_eval_plain(x, pre, w1, b1, w2, bt, skw, act, pool)
    raise ValueError(f"resblock_eval: unsupported device {x.device}")


resblock_eval.launches = 0
