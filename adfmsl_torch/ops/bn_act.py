"""Train-mode BatchNorm + activation whose backward recomputes the
pre-activation (port of ``adfmsl/ops/bn_act.py``).

Plain autograd of ``BatchNorm -> act`` keeps the pre-activation
``z = x*a + b`` for the backward: a full (B, T, C) write in the forward and
read in the backward. ``norm_act`` keeps x (alive anyway for the conv's
weight gradient) and the (C,) affines instead, and recomputes z in its
backward, which returns dx and the (C,) reductions da / db. ``BNAct``
computes the batch statistics in one pass over an f32 upcast of x (their
backward, d mean / N + 2 d var (x - mean) / N, also recomputes from x: eager
autograd would otherwise keep the f32 upcast, a copy of x twice its size,
which XLA's fusion never materialises), folds (mean, var, scale, bias) into
per-channel f32 affines a = scale * rsqrt(var + eps), b = bias - mean * a, and
applies ``norm_act`` on an f32 upcast of x, narrowed back to x's dtype.

adfmsl's statistics are kept exactly: the one-pass variance
E[x^2] - E[x]^2 in f32, momentum 0.9 on the biased variance (running =
0.9 * running + 0.1 * batch), no update outside a train-mode forward (flax
skips it at init). Parameters ``scale`` / ``bias`` and buffers ``mean`` /
``var`` map one to one onto adfmsl's ``params`` / ``batch_stats``.

The layout is adfmsl's: channels last, x (..., C). This is adfmsl's XLA
``custom_vjp``, not a Pallas kernel: it launches no kernel of its own, and
no model calls it, as in adfmsl.
"""
from __future__ import annotations

import torch
from torch import nn

_SELU_LAMBDA = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772


def _act_fwd(z: torch.Tensor, act: str) -> torch.Tensor:
    """act(z), overwriting z (an f32 temporary of the caller's)."""
    if act == "relu":
        return z.clamp_min_(0.0)
    if act == "leaky":
        return torch.maximum(z, 0.3 * z)
    if act == "selu":
        return torch.where(z > 0, z, torch.expm1(z).mul_(_SELU_ALPHA)).mul_(_SELU_LAMBDA)
    raise ValueError(f"unknown act {act!r}")


def _act_grad_into(z: torch.Tensor, act: str) -> torch.Tensor:
    """act'(z) in z's own storage (z is consumed)."""
    above = z > 0
    if act == "relu":
        return z.zero_().masked_fill_(above, 1.0)
    if act == "leaky":
        return z.fill_(0.3).masked_fill_(above, 1.0)
    if act == "selu":
        return z.exp_().mul_(_SELU_ALPHA).masked_fill_(above, 1.0).mul_(_SELU_LAMBDA)
    raise ValueError(f"unknown act {act!r}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    """An f32 copy of x that the caller may overwrite (``x.float()`` of an f32
    x is x itself)."""
    return x.to(torch.float32, copy=True)


def _affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z = x * a + b on an f32 upcast, in one f32 buffer."""
    return _f32(x).mul_(a).add_(b)


class _NormAct(torch.autograd.Function):
    """y = act(x * a + b) on an f32 upcast, narrowed to x's dtype; the
    backward recomputes z from x, in place where it can (f32 temporaries
    twice x's size each are what the backward's peak memory is made of)."""

    @staticmethod
    def forward(ctx, x, a, b, act):
        ctx.act = act
        ctx.save_for_backward(x, a, b)
        return _act_fwd(_affine(x, a, b), act).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, a, b = ctx.saved_tensors
        dz = _f32(dy).mul_(_act_grad_into(_affine(x, a, b), ctx.act))   # z recomputed
        red = tuple(range(x.dim() - 1))
        return (dz * a).to(x.dtype), (dz * x).sum(red), dz.sum(red), None


class _Moments(torch.autograd.Function):
    """(mean, E[x^2] - mean^2) over every axis but the last, in f32; the
    backward recomputes the f32 upcast from x."""

    @staticmethod
    def forward(ctx, x):
        red = tuple(range(x.dim() - 1))
        xf = _f32(x)
        mean = xf.mean(red)
        var = xf.mul_(xf).mean(red) - mean * mean
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        # d mean / n + 2 d var (x - mean) / n
        return _f32(x).mul_(2.0 * dvar).add_(dmean - 2.0 * mean * dvar).div_(n).to(x.dtype)


def norm_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             act: str = "relu") -> torch.Tensor:
    """act(x * a + b) for x (..., C) of any float dtype and (C,) affines."""
    return _NormAct.apply(x, a.float(), b.float(), act)


class BNAct(nn.Module):
    """``BatchNorm(momentum=0.9) -> act`` on channels-last (..., C) inputs,
    with ``norm_act``'s backward."""

    def __init__(self, channels: int, act: str = "relu", momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.act, self.momentum, self.epsilon = channels, act, momentum, epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = _Moments.apply(x)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        a = self.scale * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        return norm_act(x if x.dtype == self.dtype else x.to(self.dtype), a, b, self.act)
