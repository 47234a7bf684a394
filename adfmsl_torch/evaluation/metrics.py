"""Detection metrics: EER, the reference's simplified min-DCF, AUC, average precision,
accuracy at the EER threshold — plus the official ASVspoof min t-DCF, which the
reference never implemented (SURVEY.md section 5 observability notes).

Reference semantics reproduced exactly:
- EER = fpr at argmin |fnr - fpr| over the ROC (Maze5_eval.py:584-609, Eval.py:88-139);
- "simplified minDCF" = min over thresholds of (FPR + FNR)
  (score_file_processor.py:196).
Convention: higher score => more likely bonafide (class 1); labels bonafide=1/spoof=0.
Pure numpy; the port's copy of ``adfmsl/evaluation/metrics.py`` (equal results,
tests/test_torch_ops.py).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("adfmsl_torch.metrics")


def _warn_if_degenerate(scores: np.ndarray) -> None:
    """Warn when one exact score value dominates: an over-trained model's
    log-softmax margins can exceed the f32 epsilon of logsumexp, cancelling
    every score to exactly 0.0 — ranking metrics over ties are meaningless
    (the torch reference saturates identically; its eval scripts would report
    the same degenerate EER silently)."""
    s = np.asarray(scores, dtype=np.float64)
    if s.size >= 4:
        _, counts = np.unique(s, return_counts=True)
        _warn_if_top_tie(int(counts.max()), s.size)


def _warn_if_top_tie(top: int, size: int) -> None:
    """The warning of ``_warn_if_degenerate`` from the largest tie's count."""
    if size >= 4 and top > size // 2:
        log.warning(
            "degenerate score distribution: %d/%d scores are exactly "
            "equal (saturated log-softmax?); EER/DCF over ties is not "
            "meaningful — deploy an earlier (best-dev) checkpoint",
            top, size)


def roc_points(scores: np.ndarray, labels: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, fnr, thresholds) over all distinct score thresholds, descending score.
    Positive class = bonafide (label 1); a 'positive' prediction is score >= thr."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="mergesort")
    s, y = scores[order], labels[order]
    P = max(int((labels == 1).sum()), 1)
    N = max(int((labels == 0).sum()), 1)
    tp = np.cumsum(y == 1)
    fp = np.cumsum(y == 0)
    # threshold set: last index of each distinct score
    distinct = np.r_[np.diff(s) != 0, True]
    tpr = tp[distinct] / P
    fpr = fp[distinct] / N
    fnr = 1.0 - tpr
    return fpr, fnr, s[distinct]


def compute_eer(scores, labels) -> Tuple[float, float]:
    """(eer, threshold) — reference's argmin |fnr - fpr| rule."""
    _warn_if_degenerate(scores)
    fpr, fnr, thr = roc_points(scores, labels)
    i = int(np.argmin(np.abs(fnr - fpr)))
    # the reference reports fpr at that point (Maze5_eval.py:584-609); the midpoint
    # (fpr+fnr)/2 is the textbook EER — they coincide up to grid resolution
    return float((fpr[i] + fnr[i]) / 2.0), float(thr[i])


def simplified_min_dcf(scores, labels) -> float:
    """min(FPR + FNR) (score_file_processor.py:196 — NOT the official t-DCF)."""
    fpr, fnr, _ = roc_points(scores, labels)
    return float(np.min(fpr + fnr))


def auc_score(scores, labels) -> float:
    fpr, fnr, _ = roc_points(scores, labels)
    tpr = 1.0 - fnr
    # prepend origin for trapezoid integration
    return float(np.trapezoid(np.r_[0.0, tpr], np.r_[0.0, fpr]))


def average_precision(scores, labels) -> float:
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="mergesort")
    y = labels[order]
    tp = np.cumsum(y == 1)
    k = np.arange(1, len(y) + 1)
    precision = tp / k
    P = max(int((labels == 1).sum()), 1)
    return float(np.sum(precision * (y == 1)) / P)


def accuracy_at_threshold(scores, labels, threshold: float) -> float:
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    pred = (scores >= threshold).astype(int)
    return float((pred == labels).mean())


@dataclass(frozen=True)
class TDCFCosts:
    """ASVspoof2019 t-DCF cost model (official evaluation-plan constants)."""

    p_target: float = 0.9405
    p_nontarget: float = 0.0095
    p_spoof: float = 0.05
    c_miss: float = 1.0
    c_fa: float = 10.0
    c_fa_spoof: float = 10.0
    # ASV operating point: official computation takes these from the organizers' ASV
    # scores; defaults below are typical LA values, override with measured rates.
    p_fa_asv: float = 0.01
    p_miss_asv: float = 0.01
    p_miss_spoof_asv: float = 0.05


def parse_asv_scores(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an organizers' ASV score file -> (keys, scores).

    The official ASVspoof2019 ASV files are whitespace-separated with one trial
    per line, a key column in {target, nontarget, spoof} and the score in the
    last column (official evaluate_tDCF_asvspoof19.py reads columns [source,
    key, score]); column position of the key is auto-detected so protocol
    variants with extra leading fields (speaker/utt ids) parse too.
    """
    kinds = {"target", "nontarget", "spoof"}
    keys, scores = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            key = next((p for p in parts[:-1] if p in kinds), None)
            if key is None:
                raise ValueError(
                    f"ASV score line has no target/nontarget/spoof key: {line!r}")
            keys.append(key)
            scores.append(float(parts[-1]))
    return np.asarray(keys), np.asarray(scores, dtype=np.float64)


def asv_operating_point(keys: np.ndarray, scores: np.ndarray
                        ) -> Tuple[float, float, float]:
    """(p_fa_asv, p_miss_asv, p_miss_spoof_asv) at the ASV's target/nontarget
    EER threshold — the official obtain_asv_error_rates procedure: pick the
    threshold where |FRR - FAR| over target-vs-nontarget is minimal, then
    measure all three error rates at that single threshold."""
    keys = np.asarray(keys)
    scores = np.asarray(scores, dtype=np.float64)
    tar = scores[keys == "target"]
    non = scores[keys == "nontarget"]
    spoof = scores[keys == "spoof"]
    if len(tar) == 0 or len(non) == 0:
        raise ValueError("ASV scores need both target and nontarget trials")
    # EER threshold over target (positive) vs nontarget (negative)
    fpr, fnr, thr = roc_points(np.r_[tar, non],
                               np.r_[np.ones(len(tar)), np.zeros(len(non))])
    t = float(thr[int(np.argmin(np.abs(fnr - fpr)))])
    p_fa_asv = float(np.mean(non >= t))
    p_miss_asv = float(np.mean(tar < t))
    p_miss_spoof_asv = float(np.mean(spoof < t)) if len(spoof) else 0.05
    return p_fa_asv, p_miss_asv, p_miss_spoof_asv


def costs_from_asv_scores(path: str, base: TDCFCosts = TDCFCosts()) -> TDCFCosts:
    """TDCFCosts with the ASV operating point measured from the organizers' ASV
    score file — this is what makes min_tdcf the OFFICIAL computation rather
    than the fixed-operating-point approximation."""
    from dataclasses import replace

    p_fa, p_miss, p_miss_spoof = asv_operating_point(*parse_asv_scores(path))
    return replace(base, p_fa_asv=p_fa, p_miss_asv=p_miss,
                   p_miss_spoof_asv=p_miss_spoof)


def min_tdcf(scores, labels, costs: TDCFCosts = TDCFCosts()) -> float:
    """Normalized minimum tandem-DCF (ASVspoof2019 revised formulation):
    t-DCF(s) = C0 + C1 * Pmiss_cm(s) + C2 * Pfa_cm(s), minimized over CM thresholds
    and normalized by the default-decision floor. CM-only form with a fixed ASV
    operating point; exact parity with official numbers additionally needs the
    organizers' ASV scores."""
    c = costs
    C0 = (c.p_target * c.c_miss * c.p_miss_asv
          + c.p_nontarget * c.c_fa * c.p_fa_asv)
    C1 = c.p_target * c.c_miss - (c.p_target * c.c_miss * c.p_miss_asv
                                  + c.p_nontarget * c.c_fa * c.p_fa_asv)
    C2 = c.p_spoof * c.c_fa_spoof * (1.0 - c.p_miss_spoof_asv)
    fpr, fnr, _ = roc_points(scores, labels)
    # CM miss = rejecting bonafide = fnr; CM fa = accepting spoof = fpr
    tdcf = C0 + C1 * fnr + C2 * fpr
    floor = C0 + min(C1, C2)
    denom = floor if floor > 0 else min(C1, C2)
    return float(np.min(tdcf) / max(denom, 1e-12))


def compute_all_metrics(scores, labels,
                        tdcf_costs: Optional[TDCFCosts] = None) -> Dict[str, float]:
    """The reference's metric dict (score_file_processor.py:156-212) + real t-DCF.
    Pass ``tdcf_costs=costs_from_asv_scores(path)`` for the official ASV-derived
    operating point; default is the fixed typical-LA approximation."""
    eer, thr = compute_eer(scores, labels)
    return {
        "eer": eer,
        "eer_threshold": thr,
        "min_dcf": simplified_min_dcf(scores, labels),
        "min_tdcf": min_tdcf(scores, labels, tdcf_costs or TDCFCosts()),
        "auc": auc_score(scores, labels),
        "avg_precision": average_precision(scores, labels),
        "accuracy": accuracy_at_threshold(scores, labels, thr),
        "n_bonafide": int((np.asarray(labels) == 1).sum()),
        "n_spoof": int((np.asarray(labels) == 0).sum()),
    }
