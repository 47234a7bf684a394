"""Per-utterance cepstral mean/variance normalisation: port of
``adfmsl/ops/cmvn.py``."""
from __future__ import annotations

import torch


def cmvn(feats: torch.Tensor, axis: int = -2, eps: float = 1e-8,
         var_norm: bool = True) -> torch.Tensor:
    """Normalise (..., frames, coeffs) over the frame axis. The variance is
    the population variance (``jnp.var``'s), not torch's unbiased default."""
    out = feats - feats.mean(dim=axis, keepdim=True)
    if var_norm:
        out = out / torch.sqrt(feats.var(dim=axis, keepdim=True, correction=0) + eps)
    return out
