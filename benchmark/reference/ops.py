"""Plain operations of the references, in channels-first (B, C, T) layout.

``Prec`` says how the operands of a product are rounded: 'f32' keeps them (the
reference), 'fp8' rounds each operand to float8 e4m3 with a per-tensor scale
that maps its largest magnitude to 448 and accumulates in float32 (the
control: the precision below the bfloat16 that the configurations state),
and in a backward rounds each operand's gradient to float8 e5m2 the same way,
as float8 training does. Only what the configuration computes in bfloat16
takes ``low``: the products' operands and results, and the tensors it keeps
in bfloat16 between them (``Prec.q(x, True)`` at those points).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    s = FP8[dtype] / x.abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).float() / s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Prec:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor, low: bool) -> torch.Tensor:
        if not low or self.name == "f32" or x is None:
            return x
        return _Fp8.apply(x)


CALIBRATE = "__calibrate__"


@contextlib.contextmanager
def no_tf32():
    """float32 products stay float32 on the card, inside the block only."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def conv(x, w, b, prec: Prec, low: bool, stride: int = 1, padding: int = 0,
         groups: int = 1):
    return prec.q(F.conv1d(prec.q(x, low), prec.q(w, low), b, stride=stride,
                           padding=padding, groups=groups), low)


def linear(x, w, b, prec: Prec, low: bool):
    y = prec.q(x, low) @ prec.q(w, low).t()
    return prec.q(y if b is None else y + b, low)


def bn_eval(x, sd, name, eps=1e-5):
    """BatchNorm from running statistics over the channel axis 1. While
    ``sd[CALIBRATE]`` is set, the running statistics are first set from this
    input's: mean + m * std and var * v, with m and v the drawn running mean
    and variance (``benchlib.weights``)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if sd.get(CALIBRATE):
        dims = [0] + list(range(2, x.dim()))
        var, mean = torch.var_mean(x, dims, unbiased=False)
        sd[f"{name}.running_mean"] = mean + sd[f"{name}.running_mean"] * var.sqrt()
        sd[f"{name}.running_var"] = var * sd[f"{name}.running_var"]
    inv = torch.rsqrt(sd[f"{name}.running_var"] + eps) * sd[f"{name}.weight"]
    return ((x - sd[f"{name}.running_mean"].view(shape)) * inv.view(shape)
            + sd[f"{name}.bias"].view(shape))


def bn_train(x, sd, name, eps=1e-5):
    """BatchNorm from the batch statistics (biased variance) over every axis
    but 1."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * sd[f"{name}.weight"].view(shape)
            + sd[f"{name}.bias"].view(shape))


def layer_norm(x, sd, name, eps):
    """LayerNorm over the last axis."""
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def mel_edges(n: int, sample_rate: int, min_low_hz: float, min_band_hz: float):
    """Mel-spaced (HTK) band edges from 30 Hz to sr/2 - (min_low + min_band):
    the SincNet initialisation (low = edges[:-1], band = diff)."""
    lo, hi = 30.0, sample_rate / 2.0 - (min_low_hz + min_band_hz)
    mel = np.linspace(2595.0 * np.log10(1 + lo / 700.0), 2595.0 * np.log10(1 + hi / 700.0),
                      n + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def sinc_filters(low_hz, band_hz, k: int, sample_rate: int, min_low_hz: float,
                 min_band_hz: float):
    """The windowed-sinc band-pass filters (C, K) of SincNet (Ravanelli and
    Bengio 2018): h = 2 f_hi sinc(2 f_hi n) - 2 f_lo sinc(2 f_lo n), edges
    low = min_low + |low_hz|, high = clip(low + min_band + |band_hz|,
    min_low, sr/2), a symmetric Hann window."""
    if k % 2 == 0:
        k += 1
    dev = low_hz.device
    n = (torch.arange(k, dtype=torch.float32, device=dev) - (k - 1) / 2.0) / sample_rate
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(k, device=dev) / (k - 1))
    low = min_low_hz + low_hz.abs()
    high = torch.minimum(torch.maximum(low + min_band_hz + band_hz.abs(),
                                       low.new_tensor(min_low_hz)),
                         low.new_tensor(sample_rate / 2.0))
    f_lo, f_hi = (low / sample_rate)[:, None], (high / sample_rate)[:, None]
    h = (2 * f_hi * torch.sinc(2 * f_hi * sample_rate * n[None])
         - 2 * f_lo * torch.sinc(2 * f_lo * sample_rate * n[None]))
    return window.float()[None] * h


def overlap_avg_pool(x, stride: int):
    """AvgPool(2s-1, s, pad s-1) over time, counting the pads."""
    return F.avg_pool1d(x, 2 * stride - 1, stride, stride - 1, count_include_pad=True)


def se_gate(out, sd, name):
    """Squeeze-excitation: sigmoid(W2 relu(W1 mean_t(out))), bias-free."""
    g = torch.relu(out.mean(2) @ sd[f"{name}.fc1.weight"].t()) @ sd[f"{name}.fc2.weight"].t()
    return out * torch.sigmoid(g)[:, :, None]


def resblock(x, sd, name, stride: int, first: bool, prec: Prec, train: bool = False,
             dropout=None):
    """The 'tpu' SE-residual block: the overlap pool downsamples the input,
    then [BN, ReLU], conv3, BN, ReLU, dropout, conv3, plus the input (through
    a 1x1 conv on a channel change), then the SE gate. ``dropout(h)`` is the
    train step's mask, drawn by the caller."""
    if stride > 1:
        x = overlap_avg_pool(x, stride)
    bn = bn_train if train else bn_eval
    h = x if first else torch.relu(bn(x, sd, f"{name}.bn1"))
    h = conv(h, sd[f"{name}.conv1.weight"], sd[f"{name}.conv1.bias"], prec, True, padding=1)
    h = torch.relu(bn(h, sd, f"{name}.bn2"))
    if dropout is not None:
        h = dropout(h)
    h = conv(h, sd[f"{name}.conv2.weight"], sd[f"{name}.conv2.bias"], prec, True, padding=1)
    skip = x
    if f"{name}.downsample.weight" in sd:
        skip = conv(x, sd[f"{name}.downsample.weight"], sd[f"{name}.downsample.bias"],
                    prec, True)
    return prec.q(se_gate(h + skip, sd, f"{name}.se"), True)


def score_of(logits, kind: str):
    return torch.log_softmax(logits, -1)[:, 1] if kind == "log_softmax" else logits[:, 1]


def blocks_of(cfg) -> list:
    return [tuple(b) for b in cfg["blocks"]]


def out_len(t: int, k: int, stride: int, padding: int = 0) -> int:
    return (t + 2 * padding - k) // stride + 1


def conv_flops(t_out: int, cin: int, cout: int, k: int, groups: int = 1) -> float:
    """Multiply-adds of a conv, counted as 2 operations each."""
    return 2.0 * t_out * cout * (cin // groups) * k


def linear_flops(rows: int, fin: int, fout: int) -> float:
    return 2.0 * rows * fin * fout


def trunk_flops(blocks, t: int) -> float:
    """The 'tpu' blocks' convs at input length ``t``; returns (flops, t_out)."""
    total = 0.0
    for cin, cout, stride in blocks:
        t = -(-t // stride)
        total += conv_flops(t, cin, cout, 3) + conv_flops(t, cout, cout, 3)
        if cin != cout:
            total += conv_flops(t, cin, cout, 1)
    return total, t


def k1_calls(blocks, t: int) -> list:
    """(T, Cin, Cout, pre, 1x1 skip) of each K1 call of one forward."""
    calls = []
    for i, (cin, cout, stride) in enumerate(blocks):
        t = -(-t // stride)
        calls.append((t, cin, cout, i > 0, cin != cout))
    return calls


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator], device):
    """Inverted dropout's multiplier: 1/keep where a uniform draw is below keep."""
    keep = 1.0 - rate
    return (torch.rand(shape, generator=generator, device=device) < keep).float() / keep
