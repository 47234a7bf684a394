"""Two-model head-to-head comparison (port of ``adfmsl/analysis/compare.py``).

Rebuild of ``comprehensive_evaluation.py`` (SURVEY.md 2.6): checkpoint architecture
auto-detection by probing the state dict (the reference probes state-dict keys for
Wav2Vec2 dim 768 vs 1024 and FMSL prototype count, :227-446), paired evaluation on
the same protocol, prediction diagnostics, bootstrap significance (:654-698), and a
markdown report (:783). Figures are rendered by analysis.figures.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from adfmsl_torch.evaluation.bootstrap import bootstrap_metric, paired_bootstrap_test
from adfmsl_torch.evaluation.metrics import compute_all_metrics, compute_eer

_W2V2_LAYER = re.compile(r"^wav2vec2\.layers[._](\d+)\.")


def detect_architecture(state: Union[torch.nn.Module, Mapping[str, Any]]) -> Dict[str, Any]:
    """Infer architecture facts from a model or its ``state_dict()``
    (checkpoint auto-detection, comprehensive_evaluation.py:227-446 analog).
    The dict equals adfmsl's for the same model: the top-level names are
    flax's, ``wav2vec2_dim`` is the projection's output width (flax's kernel
    (in, out) is the port's Linear weight (out, in)), and the encoder's
    layers are counted by their distinct indices."""
    sd = state.state_dict() if isinstance(state, torch.nn.Module) else state
    top = {k.split(".", 1)[0] for k in sd}
    info: Dict[str, Any] = {
        "has_wav2vec2": "wav2vec2" in top,
        "has_fmsl": "fmsl" in top,
        "has_sinc": "sinc" in top or "encoder" in top,
        "has_transformer": "transformer" in top,
    }
    if info["has_wav2vec2"]:
        w = sd.get("wav2vec2.feature_projection.weight")
        if w is not None:
            info["wav2vec2_dim"] = int(w.shape[0])
            info["wav2vec2_layers"] = len({m.group(1) for m in map(_W2V2_LAYER.match, sd)
                                           if m})
    if info["has_fmsl"]:
        p = sd.get("fmsl.prototypes")
        if p is not None:
            info["n_prototypes"] = int(p.shape[0])
            info["fmsl_dim"] = int(p.shape[1])
    return info


@dataclass
class ComparisonResult:
    name_a: str
    name_b: str
    metrics_a: Dict[str, float]
    metrics_b: Dict[str, float]
    significance: Dict[str, float]
    bootstrap_a: Tuple[float, float, float]      # point, lo, hi
    bootstrap_b: Tuple[float, float, float]
    diagnostics: Dict[str, Any] = field(default_factory=dict)

    def markdown(self) -> str:
        a, b = self.metrics_a, self.metrics_b
        sig = self.significance
        better = self.name_a if a["eer"] < b["eer"] else self.name_b
        lines = [
            f"# Head-to-head: {self.name_a} vs {self.name_b}", "",
            "| metric | " + self.name_a + " | " + self.name_b + " |",
            "|---|---|---|",
        ]
        for k in ["eer", "min_dcf", "min_tdcf", "auc", "avg_precision", "accuracy"]:
            lines.append(f"| {k} | {a[k]:.4f} | {b[k]:.4f} |")
        lines += [
            "",
            f"EER 95% CI — {self.name_a}: [{self.bootstrap_a[1]:.4f}, "
            f"{self.bootstrap_a[2]:.4f}], {self.name_b}: "
            f"[{self.bootstrap_b[1]:.4f}, {self.bootstrap_b[2]:.4f}]",
            f"Paired bootstrap dEER = {sig['diff']:+.4f} "
            f"(95% CI [{sig['ci_low']:+.4f}, {sig['ci_high']:+.4f}], "
            f"p = {sig['p_value']:.3f})",
            f"**Better model: {better}**"
            + (" (significant at p<0.05)" if sig["p_value"] < 0.05 else
               " (difference NOT significant)"),
        ]
        if self.diagnostics:
            lines += ["", "Diagnostics:"]
            for k, v in self.diagnostics.items():
                lines.append(f"- {k}: {v}")
        return "\n".join(lines)


def compare_models(scores_a: Dict[str, float], scores_b: Dict[str, float],
                   labels: Dict[str, int], name_a: str = "model_a",
                   name_b: str = "model_b", n_resamples: int = 1000,
                   seed: int = 0) -> ComparisonResult:
    """Paired comparison on the intersection of scored+labelled utterances."""
    common = sorted(set(scores_a) & set(scores_b) & set(labels))
    if len(common) < 4:
        raise ValueError(f"only {len(common)} common scored utterances")
    sa = np.asarray([scores_a[u] for u in common])
    sb = np.asarray([scores_b[u] for u in common])
    y = np.asarray([labels[u] for u in common])

    ba = bootstrap_metric(sa, y, n_resamples=n_resamples, seed=seed)
    bb = bootstrap_metric(sb, y, n_resamples=n_resamples, seed=seed)
    sig = paired_bootstrap_test(sa, sb, y, n_resamples=n_resamples, seed=seed)

    # prediction diagnostics (comprehensive_evaluation.py:516 analog)
    thr_a, thr_b = compute_eer(sa, y)[1], compute_eer(sb, y)[1]
    pred_a, pred_b = sa >= thr_a, sb >= thr_b
    agree = float((pred_a == pred_b).mean())
    both_wrong = float(((pred_a != y.astype(bool)) & (pred_b != y.astype(bool))).mean())
    diagnostics = {
        "n_common": len(common),
        "prediction_agreement": round(agree, 4),
        "both_wrong_rate": round(both_wrong, 4),
        "score_correlation": round(float(np.corrcoef(sa, sb)[0, 1]), 4),
    }
    return ComparisonResult(
        name_a, name_b,
        compute_all_metrics(sa, y), compute_all_metrics(sb, y),
        sig, (ba.point, ba.ci_low, ba.ci_high), (bb.point, bb.ci_low, bb.ci_high),
        diagnostics)
