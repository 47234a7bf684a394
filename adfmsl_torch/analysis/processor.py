"""Score-file aggregation and per-model metric computation (port of
``adfmsl/analysis/processor.py``).

Rebuild of ``ScoreFileProcessor`` (score_file_processor.py:30-353): discover
``*_scores.txt`` under a directory, map file names to registry model names, join with
protocol labels, compute the metric dict per model, export JSON + a text summary.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

from adfmsl_torch.data.protocol import parse_protocol
from adfmsl_torch.evaluation.metrics import compute_all_metrics
from adfmsl_torch.evaluation.scores import join_scores_with_labels, read_score_file

# maze5_fmsl_scores.txt / main_scores.txt / maze3_eval_scores.txt ... (reference
# regex mapping, score_file_processor.py:97-137)
# boundaries: 'cross_domain_scores.txt' must not match 'main',
# 'remainder' must not match 'main' either
_NAME_RE = re.compile(r"(?<![a-z0-9])(main|maze\d+)(?:_(fmsl))?(?![a-z0-9])",
                      re.IGNORECASE)


def model_name_from_filename(fname: str) -> Optional[str]:
    base = os.path.basename(fname).lower()
    m = _NAME_RE.search(base)
    if m:
        return m.group(1) + ("_fmsl" if m.group(2) else "")
    # the extra families (lcnn_lfcc / lcnn1d_lfcc / resnet18_logmel)
    # fall outside the reference's maze naming — accept the stem before the
    # '_scores' marker, but ONLY for registry-known names so aggregates like
    # 'all_scores.txt' don't become bogus model rows
    stem = re.sub(r"_?(eval_)?scores.*$", "", base.removesuffix(".txt"))
    from adfmsl_torch.config.standardized import EXTRA_MODELS
    return stem if stem in EXTRA_MODELS else None


@dataclass
class ProcessedScores:
    per_model: Dict[str, Dict] = field(default_factory=dict)
    missing_labels: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        lines = ["MODEL PERFORMANCE SUMMARY", "=" * 64,
                 f"{'model':14s} {'EER':>8s} {'minDCF':>8s} {'min-tDCF':>9s} "
                 f"{'AUC':>8s} {'acc':>8s}"]
        for name in sorted(self.per_model):
            m = self.per_model[name]
            lines.append(f"{name:14s} {m['eer']:8.4f} {m['min_dcf']:8.4f} "
                         f"{m['min_tdcf']:9.4f} {m['auc']:8.4f} {m['accuracy']:8.4f}")
        return "\n".join(lines)


class ScoreFileProcessor:
    def __init__(self, scores_dir: str, protocol_path: str,
                 polarity: str = "bonafide1", asv_scores: str = None):
        self.scores_dir = scores_dir
        self.protocol = parse_protocol(protocol_path, polarity)
        # organizers' ASV score file -> official t-DCF operating point
        self.tdcf_costs = None
        if asv_scores:
            from adfmsl_torch.evaluation.metrics import costs_from_asv_scores
            self.tdcf_costs = costs_from_asv_scores(asv_scores)

    def discover(self) -> Dict[str, str]:
        """model name -> score file path (newest wins on collision)."""
        found: Dict[str, str] = {}
        for root, _, files in os.walk(self.scores_dir):
            for f in sorted(files):
                if not f.endswith(".txt") or "scores" not in f.lower():
                    continue
                name = model_name_from_filename(f)
                if name:
                    path = os.path.join(root, f)
                    prev = found.get(name)
                    if prev is None or os.path.getmtime(path) >= os.path.getmtime(prev):
                        found[name] = path   # newest wins on collision
        return found

    def process_all_scores(self) -> ProcessedScores:
        out = ProcessedScores()
        labels = self.protocol.labels
        for name, path in self.discover().items():
            scores = read_score_file(path)
            s, y, missing = join_scores_with_labels(scores, labels)
            if len(set(y)) < 2:
                continue
            out.per_model[name] = compute_all_metrics(s, y, tdcf_costs=self.tdcf_costs)
            out.per_model[name]["score_file"] = path
            out.missing_labels[name] = len(missing)
        return out

    def export_for_thesis_analysis(self, processed: ProcessedScores,
                                   out_path: str) -> str:
        """JSON export (score_file_processor.py:251 contract)."""
        with open(out_path, "w") as fh:
            json.dump(processed.per_model, fh, indent=2, sort_keys=True)
        return out_path
