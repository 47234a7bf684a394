"""Kernel K6: WavLM's gated relative-position self-attention at eval, from the
projections' q, k and v to the weighted sum, in one Hopper kernel that never
writes the (B, H, T, T) scores to memory.

K6 replaces no TPU kernel: adfmsl has no WavLM, and computes attention outside
any Pallas kernel. It is the port's own, for the composition that
``models/w2v2.py:SelfAttention.forward`` runs in WavLM's form: the scores q.k
in the compute dtype, their f32 copy, ``addcmul`` with the gate times the
bias, the f32 softmax, the weights rounded to the compute dtype, the weighted
sum. Its function, at those rounding points (csrc/wavlm_attention.cu states
them per element): q, k and v as the (B, T, H * 64) bf16 outputs of the
projections (q divided by sqrt(head dim) inside, as the composition divides
it), the gate g (B, H, T) f32 and the per-distance bias row r (H, 2T - 1)
f32, whose entry T - 1 + (j - i) is the bias of query frame i and key frame j
(``bias_from_row``) -> the weighted sum as (B, T, H * 64) bf16 rows, the out
projection's input. K6 takes any T.

``attention_composition`` is that composition, the one copy of it: the
model's WavLM branch runs it wherever K6 does not (with the attention
weights' dropout in training), and ``wavlm_attention_plain``, the plain
version, is it applied to the table ``bias_from_row`` gathers.
``wavlm_attention`` runs the CUDA kernel for CUDA tensors (counting the
launch in ``wavlm_attention.launches`` and in the ``w2v2.fused_attention``
counter of ``utils/profiling.py``) and the plain version for CPU tensors;
anything else raises. The kernel is built with nvcc at its first call
(ops/_build.py). ``composition_gap`` holds the kernel's output against the
plain version within a bound derived from the rounding points.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.utils.profiling import count

HEAD_DIM = 64


def scale_query(q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """q divided by sqrt(``head_dim``) in q's dtype, as attention scales it."""
    return q / torch.tensor(math.sqrt(head_dim), dtype=torch.float32).to(q.dtype)


def bias_from_row(row: torch.Tensor, t: int) -> torch.Tensor:
    """The (H, t, t) bias of the per-distance row ``row`` (H, 2t - 1): entry
    (h, i, j) is ``row[h, t - 1 + j - i]``."""
    pos = torch.arange(t, device=row.device)
    return row[:, (t - 1) + pos[None, :] - pos[:, None]]


def attention_composition(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          gate: torch.Tensor, bias: torch.Tensor, dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          training: bool = False) -> torch.Tensor:
    """WavLM's gated attention core as the composition computes it, in q's
    dtype: the scores q.k, their f32 copy plus gate * bias (``addcmul``), the
    f32 softmax, the weights rounded to q's dtype (then the attention
    weights' dropout, acting only in ``training``), the weighted sum. q
    (already divided by sqrt(d)), k, v (B, T, H * d), gate (B, H, T) f32,
    bias (H, T, T) f32 -> (B, T, H * d) in q's dtype."""
    b, t, width = q.shape
    heads = gate.shape[1]
    qh, kh, vh = (x.view(b, t, heads, width // heads).transpose(1, 2) for x in (q, k, v))
    s = torch.addcmul(torch.matmul(qh, kh.transpose(-1, -2)).float(), gate[..., None], bias)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    w = dropout(w, dropout_rate, generator, training)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, t, width)


def wavlm_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          gate: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """K6's function in plain PyTorch: ``attention_composition`` of q divided
    by sqrt(d) and the table gathered from ``row``. q, k, v (B, T, H * d),
    gate (B, H, T) f32, row (H, 2T - 1) f32 -> (B, T, H * d) in q's dtype."""
    t, width = q.shape[1:]
    return attention_composition(scale_query(q, width // row.shape[0]), k, v, gate,
                                 bias_from_row(row, t))


def composition_gap(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    gate: torch.Tensor, row: torch.Tensor) -> dict:
    """``out`` (K6's) against the plain version's output on the same device,
    element by element, one batch row at a time,
    both against the exact attention of the same operands (f64, the scores
    unrounded: the f32 composition's function).

    The bound of an element (i, c): each side's scores are bf16 roundings of
    q.k (at most one bf16 ulp, 2^-7 |s|, off the exact product where it is no
    bf16 value, either rounding being possible once the f32 sums differ; the
    f32 sum of 64 products 2^-18 sum |q k| before it), and f32 sums with the
    bias whose exponent is evaluated in f32 (2^-21 (|s| + |g r|) for both);
    so a row's log-weights move by at most twice the row's largest such shift
    t, its weights by expm1(2 t). Each side then rounds its weights to bf16
    (2^-8; the exponential's own error 2^-18 more), sums T of them and T
    products in f32 (T 2^-22, truncating sums too) and rounds the output
    (2^-8 of it). Over A = sum_j w_j |v_jc| (exact weights) the two sides
    together: 2 (expm1(2 t) + 2^-7 + T 2^-22 + 2^-18)(1 + 2^-7) A + 2^-7 |o|.
    Returns the largest gap over its bound (at most 1 when K6 is right), the
    largest gap, and each side's largest gap to the exact attention over the
    exact output's largest magnitude (``f32_gap``, ``plain_f32_gap``)."""
    plain = wavlm_attention_plain(q, k, v, gate, row)
    bsz, t, width = q.shape
    heads = row.shape[0]
    d = width // heads
    bias = bias_from_row(row.double(), t)
    worst = biggest = f32_gap = plain_gap = 0.0
    scale = 0.0
    for i in range(bsz):
        qh, kh, vh = (x[i].double().view(t, heads, d).transpose(0, 1) for x in (q, k, v))
        qh = qh / math.sqrt(d)                                          # exact in bf16 too
        s = torch.matmul(qh, kh.transpose(-1, -2))                      # exact
        mag = torch.matmul(qh.abs(), kh.abs().transpose(-1, -2))
        gr = gate[i].double()[..., None] * bias
        x = s + gr
        w = torch.softmax(x, dim=-1)
        o = torch.matmul(w, vh)                                         # (H, T, d)
        a = torch.matmul(w, vh.abs())
        exact = s.to(torch.bfloat16).double() == s
        shift = (torch.where(exact, 0.0, 2.0 ** -7 * s.abs()) + 2.0 ** -18 * mag
                 + 2.0 ** -21 * (s.abs() + gr.abs())).amax(-1, keepdim=True)
        rel = 2 * (torch.expm1(2 * shift) + 2.0 ** -7 + t * 2.0 ** -22 + 2.0 ** -18)
        bound = rel * (1 + 2.0 ** -7) * a + 2.0 ** -7 * o.abs()
        got, ref = (y[i].double().view(t, heads, d).transpose(0, 1) for y in (out, plain))
        gap = (got - ref).abs()
        ratio = torch.where(gap == 0, 0.0, gap / bound).nan_to_num(nan=float("inf"))
        worst = max(worst, float(ratio.max()))
        biggest = max(biggest, float(gap.max()))
        f32_gap = max(f32_gap, float((got - o).abs().max()))
        plain_gap = max(plain_gap, float((ref - o).abs().max()))
        scale = max(scale, float(o.abs().max()))
    scale = scale or 1.0
    return {"max_gap_over_bound": worst, "max_abs_gap": biggest,
            "f32_gap": f32_gap / scale, "plain_f32_gap": plain_gap / scale}


def _check_operands(q, k, v, gate, row) -> None:
    """The shapes and types the kernel takes; raises before any build."""
    if q.dim() != 3:
        raise ValueError(f"wavlm_attention: q must be (B, T, H * {HEAD_DIM}), got "
                         f"{tuple(q.shape)}")
    b, t, width = q.shape
    heads = width // HEAD_DIM
    if width % HEAD_DIM or t < 1:
        raise ValueError(f"wavlm_attention: heads of {HEAD_DIM} and T >= 1, got "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.dtype != torch.bfloat16 or tuple(x.shape) != (b, t, width)
                or x.device != q.device or x.stride(2) != 1 or x.stride(0) % 8
                or x.stride(1) % 8 or x.data_ptr() % 16):
            raise ValueError(f"wavlm_attention: {name} must be a ({b}, {t}, {width}) bf16 "
                             f"tensor on {q.device} with unit column stride, row and batch "
                             f"strides multiples of 8 and a 16-byte aligned base, got "
                             f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")
    for name, x, shape in (("gate", gate, (b, heads, t)), ("row", row, (heads, 2 * t - 1))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"wavlm_attention: {name} must be a contiguous {shape} f32 "
                             f"tensor on {q.device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from adfmsl_torch.ops._build import load_library

    lib = load_library("wavlm_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wavlm_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, ll, ll, ll, ll, ll,
                                           ll, ll, ll, i, p]
    lib.wavlm_attention_launch.restype = i
    return lib


def _launch(q, k, v, gate, row) -> torch.Tensor:
    _check_operands(q, k, v, gate, row)
    b, t, width = q.shape
    lib = _kernel_lib()
    out = torch.empty((b, t, width), dtype=torch.bfloat16, device=q.device)
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wavlm_attention_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, gate, row, out)),
            b, width // HEAD_DIM, t, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1), dev.index,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wavlm_attention: kernel launch failed with CUDA error {rc}")
    wavlm_attention.launches += 1
    count("w2v2.fused_attention")
    return out


def wavlm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                    row: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, T, H * 64) bf16 (q as projected: K6 divides it by 8), the gate
    (B, H, T) f32 and the per-distance bias row (H, 2T - 1) f32 -> the gated
    attention's weighted sum (B, T, H * 64) bf16.

    CUDA tensors launch the K6 kernel (counted in ``wavlm_attention.launches``
    and ``w2v2.fused_attention``) or raise; CPU tensors run the plain version."""
    if q.device.type == "cuda":
        return _launch(q, k, v, gate, row)
    if q.device.type == "cpu":
        return wavlm_attention_plain(q, k, v, gate, row)
    raise ValueError(f"wavlm_attention: unsupported device {q.device}")


wavlm_attention.launches = 0
