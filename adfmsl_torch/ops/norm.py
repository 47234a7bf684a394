"""BatchNorm with flax's numerics, in eval and in train mode.

The port keeps ``nn.BatchNorm1d`` only as the holder of the parameters and
buffers (weight, bias, running_mean, running_var); it never calls its
forward. flax ``nn.BatchNorm(momentum=0.9)`` differs from torch's in train
mode in two ways that matter:

- the batch variance is ``max(0, E[x^2] - E[x]^2)`` (flax's
  ``use_fast_variance``), computed in f32 even for bf16 inputs;
- the running variance is updated with that *biased* batch variance,
  ``ra = 0.9 * ra + 0.1 * batch``, where torch's ``F.batch_norm`` would use
  the unbiased one (a factor N/(N-1): 3/4 over the four rows of a batch-4
  ``proj_bn``).

So ``bn_train`` computes the statistics itself and updates the buffers
under ``no_grad``, except in the recompute of a checkpointed forward
(``ops/remat.py``), which must leave them as the first forward left them.

Inside a data-parallel step (``parallel/collectives.py:data_parallel``) the
statistics are those of the global batch, as GSPMD gives adfmsl's sync-BN:
the per-channel sums of x and x², and the row count, are summed over the
data group in f32 before flax's ``max(0, E[x²] - E[x]²)``, and gradients
flow back through that sum. Every rank then moves its running statistics by
the same amount. The means are sums over a count on the device in both
cases, as XLA divides ``jnp.mean``'s sum, so one rank computes what one
process does, bit for bit.
"""
from __future__ import annotations

import torch
from torch import nn

from adfmsl_torch.ops.remat import recomputing
from adfmsl_torch.parallel.collectives import global_sum

MOMENTUM = 0.9          # flax's; torch's momentum is 1 - MOMENTUM


def batch_norm(c: int) -> nn.BatchNorm1d:
    """flax ``nn.BatchNorm(momentum=0.9)``'s counterpart (eps 1e-5)."""
    return nn.BatchNorm1d(c, eps=1e-5, momentum=1.0 - MOMENTUM)


def affine(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax's ``_normalize`` from its per-channel operands: (x - mean) * mul +
    bias in f32 (three roundings, no fused multiply-add), cast to ``dtype``."""
    return ((x.float() - mean) * mul + bias).to(dtype)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               bn: nn.BatchNorm1d, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var+eps) * scale) + bias in
    f32, cast to ``dtype``."""
    return affine(x, mean, torch.rsqrt(var + bn.eps) * bn.weight, bn.bias, dtype)


def eval_affine(bn: nn.BatchNorm1d):
    """The eval BatchNorm's (mean, mul, bias), f32 (C,) each, as ``bn_eval``
    computes them: its ``affine`` operands."""
    return bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight, bn.bias


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm1d, dtype: torch.dtype) -> torch.Tensor:
    """Eval BatchNorm over the last axis from the running statistics."""
    return affine(x, *eval_affine(bn), dtype)


def bn_train(x: torch.Tensor, bn: nn.BatchNorm1d, dtype: torch.dtype) -> torch.Tensor:
    """Train BatchNorm over the last axis: normalise with the batch statistics
    (over every other axis, in f32, over the global batch in a data-parallel
    step; gradients flow through them) and move the running statistics
    towards them as flax does (once: not again when a checkpointed forward is
    recomputed)."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    c = xf.shape[-1]
    count = torch.full((1,), xf.numel() // c, dtype=torch.float32, device=x.device)
    sums = global_sum(torch.cat([xf.sum(axes), (xf * xf).sum(axes), count]))
    n = sums[2 * c]
    mean = sums[:c] / n
    var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
    if not recomputing():
        with torch.no_grad():
            bn.running_mean.copy_(MOMENTUM * bn.running_mean + (1.0 - MOMENTUM) * mean)
            bn.running_var.copy_(MOMENTUM * bn.running_var + (1.0 - MOMENTUM) * var)
    return _normalize(xf, mean, var, bn, dtype)


def bn_forward(x: torch.Tensor, bn: nn.BatchNorm1d, dtype: torch.dtype,
               train: bool) -> torch.Tensor:
    """``bn_train`` in train mode, ``bn_eval`` otherwise."""
    return bn_train(x, bn, dtype) if train else bn_eval(x, bn, dtype)
