"""Dropout drawn from an explicit generator (port of ``adfmsl/ops/dropout.py``).

adfmsl's ``RDropout`` (:68) is ``nn.Dropout``'s function, ``x / keep`` where
a Bernoulli(keep) draw is true and 0 elsewhere, with a backward that
regenerates the mask from its key instead of saving it: a TPU memory choice.
Here autograd saves the mask. The bits cannot match JAX's; the parity tests
run with the rates at 0 and hold the mask statistics apart.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Identity unless ``train`` and ``rate > 0``; then the mask comes from
    ``generator``, which must live on ``x``'s device."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a generator (the 'dropout' stream)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
