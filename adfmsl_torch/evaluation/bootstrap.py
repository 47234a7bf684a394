"""Bootstrap confidence intervals and paired significance testing for model
comparison (port of ``adfmsl/evaluation/bootstrap.py``;
comprehensive_evaluation.py:654-698: 1000 resamples + paired t-test).

Host-side numpy on the port's ``compute_eer``: with the same seed the draws,
and so every result, equal adfmsl's. The default EER sorts the scores once and
reads each resample's ROC from counts a distinct score (``_resampled_eer``)
instead of sorting every resample: the same integers, so the same EERs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from adfmsl_torch.evaluation.metrics import _warn_if_top_tie, compute_eer


def _resample_both_classes(rng, labels, n, max_tries: int = 100):
    """Bootstrap index draw guaranteed to contain both classes: re-draw a
    bounded number of times, then force one index of the missing class (an
    unbounded re-draw loop would hang on near-single-class label sets)."""
    for _ in range(max_tries):
        idx = rng.integers(0, n, n)
        if len(np.unique(labels[idx])) >= 2:
            return idx
    missing = [c for c in np.unique(labels) if c not in labels[idx]]
    for c in missing:
        pool = np.flatnonzero(labels == c)
        idx[rng.integers(0, n)] = pool[rng.integers(0, len(pool))]
    return idx


@dataclass
class BootstrapResult:
    point: float
    ci_low: float
    ci_high: float
    samples: np.ndarray


def _eer(s, y):
    return compute_eer(s, y)[0]


def _resampled_eer(scores, labels):
    """``idx -> _eer(scores[idx], labels[idx])`` with one sort of ``scores``.

    ``roc_points`` of a resample takes the cumulative class counts at the last
    row of each distinct score, in descending order; those are the cumulative
    sums of each distinct score's class counts in the resample, which one
    ``bincount`` gives. Counts are exact in float64, so every EER equals the
    sorted path's. Non-finite scores keep the sorted path (each NaN row is its
    own ROC point there)."""
    s = np.asarray(scores, dtype=np.float64)
    if not np.isfinite(s).all():
        return lambda idx: _eer(scores[idx], labels[idx])
    order = np.argsort(-s, kind="mergesort")
    first = np.r_[True, np.diff(s[order]) != 0]
    group = np.empty(len(s), np.int64)
    group[order] = np.cumsum(first) - 1
    n_groups = int(first.sum())
    pos, neg = labels == 1, labels == 0

    def eer(idx):
        g = group[idx]
        count = np.bincount(g, minlength=n_groups)
        _warn_if_top_tie(int(count.max()), len(idx))
        seen = count > 0
        tp = np.cumsum(np.bincount(g, weights=pos[idx], minlength=n_groups))[seen]
        fp = np.cumsum(np.bincount(g, weights=neg[idx], minlength=n_groups))[seen]
        fpr = fp / max(int(fp[-1]), 1)
        fnr = 1.0 - tp / max(int(tp[-1]), 1)
        i = int(np.argmin(np.abs(fnr - fpr)))
        return float((fpr[i] + fnr[i]) / 2.0)
    return eer


def _resampled(metric_fn, scores, labels):
    """``idx -> metric_fn(scores[idx], labels[idx])``; the default EER sorts once."""
    if metric_fn is _eer:
        return _resampled_eer(scores, labels)
    return lambda idx: metric_fn(scores[idx], labels[idx])


def bootstrap_metric(scores, labels, metric_fn: Callable = None,
                     n_resamples: int = 1000, seed: int = 0,
                     ci: float = 0.95) -> BootstrapResult:
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    metric_fn = metric_fn or _eer
    if len(np.unique(labels)) < 2:
        raise ValueError("bootstrap needs both classes present in labels "
                         "(single-class input would re-draw forever)")
    rng = np.random.default_rng(seed)
    n = len(scores)
    resampled = _resampled(metric_fn, scores, labels)
    vals = np.empty(n_resamples)
    for i in range(n_resamples):
        vals[i] = resampled(_resample_both_classes(rng, labels, n))
    a = (1.0 - ci) / 2.0
    return BootstrapResult(float(metric_fn(scores, labels)),
                           float(np.quantile(vals, a)),
                           float(np.quantile(vals, 1 - a)), vals)


def paired_bootstrap_test(scores_a, scores_b, labels, metric_fn: Callable = None,
                          n_resamples: int = 1000, seed: int = 0) -> Dict[str, float]:
    """Paired resampling of (model A, model B) on the SAME utterances; p-value =
    fraction of resamples where the metric difference crosses zero."""
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    labels = np.asarray(labels)
    metric_fn = metric_fn or _eer
    if len(np.unique(labels)) < 2:
        raise ValueError("paired bootstrap needs both classes present in labels")
    rng = np.random.default_rng(seed)
    n = len(labels)
    metric_a = _resampled(metric_fn, scores_a, labels)
    metric_b = _resampled(metric_fn, scores_b, labels)
    diffs = np.empty(n_resamples)
    for i in range(n_resamples):
        idx = _resample_both_classes(rng, labels, n)
        diffs[i] = metric_a(idx) - metric_b(idx)
    point = metric_fn(scores_a, labels) - metric_fn(scores_b, labels)
    p = float(min((diffs >= 0).mean(), (diffs <= 0).mean()) * 2)
    return {"diff": float(point), "p_value": p,
            "ci_low": float(np.quantile(diffs, 0.025)),
            "ci_high": float(np.quantile(diffs, 0.975))}
