"""FMSL geometric classification head (port of ``adfmsl/heads/fmsl.py``).

Projection MLP -> L2 hypersphere normalisation, with AM-Softmax angular-margin
logits against a normalised class-weight matrix and cosine similarities to
learnable spoof prototypes (fmsl_advanced.py:103-359). In train mode
(adfmsl heads/fmsl.py:65-114): ``proj_bn`` normalises over the B rows with the
batch statistics, then projection dropout, latent-space augmentation noise
when ``enable_lsa``, and the angular margin on the target class. With labels
the head also returns ``ce_loss``, ``proto_loss`` and ``loss``. Both terms
are ratios of batch sums; in a data-parallel step
(``parallel/collectives.py``) the sums are those of the global batch, as
GSPMD computes adfmsl's, so every rank holds the global loss.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from adfmsl_torch.config.base import FMSLConfig
from adfmsl_torch.heads.losses import cross_entropy, masked_mean
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.norm import batch_norm, bn_forward
from adfmsl_torch.parallel.collectives import data_group, global_sum


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    # rsqrt(sum(x^2)+eps), as adfmsl: x/max(norm, eps) has a NaN gradient at 0
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def am_softmax_logits(embeddings: torch.Tensor, weight: torch.Tensor, s: float,
                      m: float, labels: Optional[torch.Tensor] = None,
                      train: bool = False) -> torch.Tensor:
    """cos(theta) against normalised class weights; additive-ANGLE margin on the
    target class during training: cos(theta+m) = cos cos m - sin sin m
    (fmsl_advanced.py:190-237), scaled by s. At eval it is s*cos."""
    cosine = embeddings @ l2_normalize(weight, dim=-1).T
    if train and labels is not None:
        # floor keeps sqrt' finite at |cos|=1
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, min=1e-8, max=1.0))
        phi = cosine * math.cos(m) - sine * math.sin(m)
        one_hot = F.one_hot(labels.long(), cosine.shape[-1]).to(cosine.dtype)
        cosine = one_hot * phi + (1.0 - one_hot) * cosine
    return s * cosine


class FMSLHead(nn.Module):
    """(B, D) features -> dict. Parameters mirror fmsl_advanced.py:103-150:
    projection Linear(D,D)+BN+ReLU+Dropout, Xavier prototypes (P, D)
    and class weights (C, D), learnable scalar temperature."""

    def __init__(self, cfg: FMSLConfig, input_dim: int, n_classes: int = 2):
        super().__init__()
        self.cfg = cfg
        d = input_dim
        self.proj = nn.Linear(d, d)
        self.proj_bn = batch_norm(d)
        self.prototypes = nn.Parameter(torch.empty(cfg.n_prototypes, d))
        self.weight = nn.Parameter(torch.empty(n_classes, d))
        self.temperature = nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """xavier_uniform prototypes/weight and unit temperature (the proj
        Linear and BN are initialised with the rest of the model)."""
        with torch.no_grad():
            nn.init.xavier_uniform_(self.prototypes, generator=generator)
            nn.init.xavier_uniform_(self.weight, generator=generator)
            self.temperature.fill_(1.0)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rngs: Optional[Mapping[str, torch.Generator]] = None
                ) -> Dict[str, torch.Tensor]:
        """``rngs`` holds the 'dropout' and 'lsa' generators that train mode
        draws from (when their rates are non-zero)."""
        rngs = rngs or {}
        train = self.training
        h = torch.relu(bn_forward(self.proj(x), self.proj_bn, torch.float32, train))
        h = dropout(h, self.cfg.proj_dropout, rngs.get("dropout"), train)
        if self.cfg.enable_lsa and train:
            noise = torch.randn(h.shape, generator=rngs["lsa"], device=h.device,
                                dtype=h.dtype)
            h = h + self.cfg.lsa_strength * noise
        emb = l2_normalize(h)
        proto_sim = emb @ l2_normalize(self.prototypes, dim=-1).T
        proto_sim = proto_sim / torch.clamp(self.temperature, min=0.01)
        logits = am_softmax_logits(emb, self.weight, self.cfg.s, self.cfg.m, labels, train)
        out = {"logits": logits, "embeddings": emb, "prototype_similarity": proto_sim}
        if labels is not None:
            ce = cross_entropy(logits, labels)
            # pull each spoof sample (label 0) toward its best prototype
            # (fmsl_advanced.py:320-359), 0 when the batch has no spoof
            best = proto_sim.max(dim=-1).values
            spoof = (labels == 0).to(logits.dtype)
            if mask is not None:
                spoof = spoof * mask.to(logits.dtype)
            if data_group() is None:
                proto_loss = -(best * spoof).sum() / (spoof.sum() + 1e-8)
                out["ce_loss"] = masked_mean(ce, mask)
            else:
                m = torch.ones_like(ce) if mask is None else mask.to(ce.dtype)
                s = global_sum(torch.stack([(ce * m).sum(), m.sum(),
                                            (best * spoof).sum(), spoof.sum()]))
                proto_loss = -s[2] / (s[3] + 1e-8)
                out["ce_loss"] = s[0] / torch.clamp(s[1], min=1.0)
            out["proto_loss"] = proto_loss
            out["loss"] = out["ce_loss"] + self.cfg.prototype_loss_weight * proto_loss
        return out
