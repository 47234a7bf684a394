"""Eval-mode BatchNorm with flax's numerics.

This slice only evaluates, so every BN reads its running stats as they are.
Training (ROADMAP slice 3) has to reproduce flax's update rule: flax momentum
0.9 is torch momentum 0.1 (set below), and flax updates the running variance
with the *biased* batch variance where torch's ``BatchNorm1d`` uses the
unbiased one.
"""
from __future__ import annotations

import torch
from torch import nn


def batch_norm(c: int) -> nn.BatchNorm1d:
    """flax ``nn.BatchNorm(momentum=0.9)``'s counterpart (eps 1e-5)."""
    return nn.BatchNorm1d(c, eps=1e-5, momentum=0.1)


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm1d, dtype: torch.dtype) -> torch.Tensor:
    """Eval BatchNorm over the last axis, computed in f32 and cast to ``dtype``
    in the order flax's ``_normalize`` uses: (x - mean) * (rsqrt(var+eps) *
    scale) + bias."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x.float() - bn.running_mean) * mul + bn.bias).to(dtype)
