"""Results tables and comparison reports (port of ``adfmsl/analysis/report.py``).

Rebuild of the reporting side of ``comprehensive_thesis_analyser.py`` (CSV/LaTeX
tables, :530) and ``comprehensive_evaluation.py`` (markdown report, :783) minus the
matplotlib figure rendering (framework scope: data products, not thesis graphics).
Also carries the reference's published results (comprehensive_thesis_analyser.py:
175-192) for regression comparison.
"""
from __future__ import annotations

import csv
import io
from typing import Dict, Optional

# Published reference results (EER / simplified minDCF / accuracy) —
# comprehensive_thesis_analyser.py:175-192, duplicated in BASELINE.md.
REFERENCE_RESULTS: Dict[str, Dict[str, float]] = {
    "main": {"eer": 0.5203, "min_dcf": 0.80, "accuracy": 0.4797},
    "maze2": {"eer": 0.5575, "min_dcf": 0.85, "accuracy": 0.4425},
    "maze3": {"eer": 0.6936, "min_dcf": 0.90, "accuracy": 0.3064},
    "maze5": {"eer": 0.3183, "min_dcf": 0.6234, "accuracy": 0.6817},
    "maze6": {"eer": 0.1529, "min_dcf": 0.30, "accuracy": 0.8470},
    "maze7": {"eer": 0.4726, "min_dcf": 0.75, "accuracy": 0.5274},
    "maze8": {"eer": 0.4889, "min_dcf": 0.76, "accuracy": 0.5111},
    "main_fmsl": {"eer": 0.2317, "min_dcf": 0.45, "accuracy": 0.7683},
    "maze2_fmsl": {"eer": 0.3603, "min_dcf": 0.65, "accuracy": 0.6397},
    "maze3_fmsl": {"eer": 0.4952, "min_dcf": 0.80, "accuracy": 0.5048},
    "maze5_fmsl": {"eer": 0.2612, "min_dcf": 0.5171, "accuracy": 0.7388},
    "maze6_fmsl": {"eer": 0.0257, "min_dcf": 0.05, "accuracy": 0.9744},
    "maze7_fmsl": {"eer": 0.2947, "min_dcf": 0.55, "accuracy": 0.7053},
    "maze8_fmsl": {"eer": 0.2825, "min_dcf": 0.52, "accuracy": 0.7175},
}

_COLS = ["eer", "min_dcf", "min_tdcf", "auc", "accuracy"]


def results_csv(per_model: Dict[str, Dict]) -> str:
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["model"] + _COLS)
    for name in sorted(per_model):
        m = per_model[name]
        w.writerow([name] + [f"{m.get(c, float('nan')):.4f}" for c in _COLS])
    return buf.getvalue()


def results_latex(per_model: Dict[str, Dict]) -> str:
    lines = [r"\begin{tabular}{l" + "r" * len(_COLS) + "}", r"\toprule",
             "model & " + " & ".join(c.replace("_", r"\_") for c in _COLS) + r" \\",
             r"\midrule"]
    for name in sorted(per_model):
        m = per_model[name]
        vals = " & ".join(f"{m.get(c, float('nan')):.4f}" for c in _COLS)
        lines.append(f"{name.replace('_', chr(92) + '_')} & {vals} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def comparison_markdown(per_model: Dict[str, Dict],
                        reference: Optional[Dict[str, Dict]] = None) -> str:
    """Markdown report with deltas vs the reference's published numbers."""
    reference = reference if reference is not None else REFERENCE_RESULTS
    lines = ["# Model evaluation report", "",
             "| model | EER | ref EER | dEER | minDCF | min t-DCF | AUC | acc |",
             "|---|---|---|---|---|---|---|---|"]
    for name in sorted(per_model):
        m = per_model[name]
        ref_eer = reference.get(name, {}).get("eer")
        if ref_eer is not None:
            head = f"| {name} | {m['eer']:.4f} | {ref_eer:.4f} | {m['eer'] - ref_eer:+.4f} | "
        else:
            head = f"| {name} | {m['eer']:.4f} | - | - | "
        lines.append(head + f"{m['min_dcf']:.4f} | "
                     f"{m.get('min_tdcf', float('nan')):.4f} | "
                     f"{m.get('auc', float('nan')):.4f} | "
                     f"{m.get('accuracy', float('nan')):.4f} |")
    lines += ["", "FMSL improvement (baseline -> +FMSL EER):"]
    for base in sorted(k for k in per_model if not k.endswith("_fmsl")):
        f = f"{base}_fmsl"
        if f in per_model:
            a, b = per_model[base]["eer"], per_model[f]["eer"]
            rel = (a - b) / a * 100 if a else 0.0
            lines.append(f"- {base}: {a:.4f} -> {b:.4f} ({rel:+.1f}%)")
    return "\n".join(lines)


def check_against_reference(per_model: Dict[str, Dict], tol_eer: float = 0.001,
                            reference: Optional[Dict[str, Dict]] = None
                            ) -> Dict[str, Dict]:
    """Regression gate vs the published thesis numbers (SURVEY.md section 7 step 7;
    the target: EER within 0.1% absolute). Returns per-model
    {eer, ref_eer, delta, within}; models without a published number are skipped."""
    reference = reference if reference is not None else REFERENCE_RESULTS
    out: Dict[str, Dict] = {}
    for name, m in per_model.items():
        ref = reference.get(name)
        if not ref or "eer" not in m:
            continue
        delta = float(m["eer"]) - float(ref["eer"])
        out[name] = {"eer": float(m["eer"]), "ref_eer": float(ref["eer"]),
                     "delta": delta, "within": abs(delta) <= tol_eer}
    return out
