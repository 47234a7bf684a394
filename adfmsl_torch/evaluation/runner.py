"""Batched evaluation runner: protocol -> score file (+ metrics).

Port of ``adfmsl/evaluation/runner.py`` (``produce_scores`` :37,
``evaluate_to_file`` :161) for one device, without adfmsl's mesh sharding
and OOM half-batch retry. Kept as there: fixed-shape batches whose padding rows
are dropped by the loader's mask, scores in protocol order, and non-finite
scores replaced by -1e9 and counted (the reference's NaN guard,
Maze6_Eval.py:474-493).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from adfmsl_torch.data.pipeline import DataLoader
from adfmsl_torch.evaluation.metrics import compute_all_metrics
from adfmsl_torch.evaluation.scores import write_score_file

log = logging.getLogger(__name__)


@dataclass
class EvalResult:
    utt_ids: List[str]
    scores: np.ndarray
    n_nonfinite: int
    metrics: Optional[Dict[str, float]] = None


def produce_scores(model: torch.nn.Module, loader: DataLoader) -> EvalResult:
    """Run batched inference on the model's device; returns per-utterance
    scores in protocol order (masked padding rows dropped). Scores stay on
    the device until the loop ends, so the host never waits on a batch."""
    dev = next(model.parameters()).device
    pending = []
    with torch.inference_mode():
        for batch in loader:
            audio = torch.from_numpy(batch.audio).to(dev, non_blocking=True)
            pending.append((model(audio)["scores"], batch.utt_ids, batch.mask))

    ids: List[str] = []
    all_scores: List[float] = []
    n_bad = 0
    for dev_scores, utt_ids, mask in pending:
        s = dev_scores.float().cpu().numpy()
        bad = ~np.isfinite(s)
        if bad.any():
            n_bad += int(bad.sum())
            s = np.where(bad, -1e9, s)
        for u, sc, m in zip(utt_ids, s, mask):
            if m:
                ids.append(u)
                all_scores.append(sc)
    if n_bad:
        log.warning("replaced %d non-finite scores", n_bad)
    return EvalResult(ids, np.asarray(all_scores, dtype=np.float64), n_bad)


def evaluate_to_file(model: torch.nn.Module, loader: DataLoader, score_path: str,
                     labels: Optional[Dict[str, int]] = None,
                     asv_scores: Optional[str] = None) -> EvalResult:
    res = produce_scores(model, loader)
    n = write_score_file(score_path, res.utt_ids, res.scores)
    log.info("wrote %d scores to %s", n, score_path)
    if labels:
        y = np.asarray([labels[u] for u in res.utt_ids if u in labels])
        s = np.asarray([sc for u, sc in zip(res.utt_ids, res.scores) if u in labels])
        costs = None
        if asv_scores:
            # official t-DCF: ASV operating point measured from the organizers'
            # ASV score file rather than the fixed typical-LA approximation
            from adfmsl_torch.evaluation.metrics import costs_from_asv_scores
            costs = costs_from_asv_scores(asv_scores)
        res.metrics = compute_all_metrics(s, y, tdcf_costs=costs)
    return res
