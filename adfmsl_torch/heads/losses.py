"""Classification losses (port of ``adfmsl/heads/losses.py``, :19-100).

Reference variants: weighted CE [0.1, 0.9] (main.py:66) / [0.3, 0.7]
(maze6.py:685), the CE-form focal loss alpha*(1-pt)^gamma*CE with alpha 0.25,
gamma 2 (maze2.py:195-207), and the BCE-form focal loss over the class-1
margin (maze3.py:79-98). All take raw logits (B, C) and integer labels (B,);
an optional validity mask (B,) supports padded batches. Weighted CE divides
by the sum of the target weights, as torch's ``CrossEntropyLoss(weight=w)``
does, not by B.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    ce = _ce(logits, labels)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)
        ce = ce * w[labels.long()]
    return ce


def focal_ce(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.25,
             gamma: float = 2.0) -> torch.Tensor:
    """CE-form focal loss (maze2.py:195-207): alpha*(1-exp(-ce))^gamma * ce."""
    ce = _ce(logits, labels)
    pt = torch.exp(-ce)
    return alpha * (1.0 - pt) ** gamma * ce


def focal_bce(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
              gamma: float = 2.0) -> torch.Tensor:
    """BCE-form focal loss (maze3.py:79-98): binary on the class-1 logit margin."""
    z = logits[:, 1] - logits[:, 0]
    y = labels.to(logits.dtype)
    p = torch.sigmoid(z)
    pt = y * p + (1.0 - y) * (1.0 - p)
    bce = -(y * torch.log(torch.clamp(p, 1e-7, 1.0))
            + (1 - y) * torch.log(torch.clamp(1 - p, 1e-7, 1.0)))
    return alpha * (1.0 - pt) ** gamma * bce


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return values.mean()
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


def loss_parts(name: str, logits: torch.Tensor, labels: torch.Tensor, *,
               class_weights: Optional[Sequence[float]] = None,
               focal_alpha: float = 0.25, focal_gamma: float = 2.0,
               mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator sum, denominator sum) with loss = num / denom, so that a
    data-parallel step can sum both over devices (adfmsl :57-91)."""
    if name == "weighted_ce" and class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logits.dtype,
                            device=logits.device)[labels.long()]
        per = _ce(logits, labels) * w
        denom_w = w
    elif name in ("ce", "weighted_ce", "fmsl"):
        # 'fmsl' models return their own loss; reaching here falls back to CE
        per = cross_entropy(logits, labels)
        denom_w = torch.ones_like(per)
    elif name == "focal_ce":
        per = focal_ce(logits, labels, focal_alpha, focal_gamma)
        denom_w = torch.ones_like(per)
    elif name == "focal_bce":
        per = focal_bce(logits, labels, focal_alpha, focal_gamma)
        denom_w = torch.ones_like(per)
    else:
        raise ValueError(f"unknown loss {name!r}")
    m = torch.ones_like(per) if mask is None else mask.to(per.dtype)
    return (per * m).sum(), (denom_w * m).sum()


def compute_loss(name: str, logits: torch.Tensor, labels: torch.Tensor, *,
                 class_weights: Optional[Sequence[float]] = None,
                 focal_alpha: float = 0.25, focal_gamma: float = 2.0,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch by ``LossConfig.name``; returns a scalar."""
    num, denom = loss_parts(name, logits, labels, class_weights=class_weights,
                            focal_alpha=focal_alpha, focal_gamma=focal_gamma, mask=mask)
    return num / torch.clamp(denom, min=1e-8)
