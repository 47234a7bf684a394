"""Figure rendering: ROC / PR / score distributions / model comparison bars
(port of ``adfmsl/analysis/figures.py``).

Rebuild of the plotting layers (``comprehensive_evaluation.py:700-781`` ROC/PR/score
plots, ``Eval.py:21-733`` comparison dashboards, ``comprehensive_thesis_analyser.py``
comparison panels — minus that file's np.random-synthesised panels, which are
deliberately NOT reproduced: every pixel here comes from real scores). Matplotlib is
imported lazily with the Agg backend so headless use always works.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from adfmsl_torch.evaluation.metrics import compute_eer, roc_points


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(scores_by_model: Dict[str, Sequence[float]], labels_by_model,
             out_path: str) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, scores in scores_by_model.items():
        y = np.asarray(labels_by_model[name])
        fpr, fnr, _ = roc_points(np.asarray(scores), y)
        eer, _ = compute_eer(scores, y)
        ax.plot(fpr, 1 - fnr, label=f"{name} (EER {eer:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_det(scores_by_model: Dict[str, Sequence[float]], labels_by_model,
             out_path: str) -> str:
    """DET curve (the standard ASVspoof presentation): FNR vs FPR on probit axes."""
    from scipy.stats import norm

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, scores in scores_by_model.items():
        y = np.asarray(labels_by_model[name])
        fpr, fnr, _ = roc_points(np.asarray(scores), y)
        keep = (fpr > 0) & (fpr < 1) & (fnr > 0) & (fnr < 1)
        ax.plot(norm.ppf(fpr[keep]), norm.ppf(fnr[keep]), label=name)
    ticks = [0.001, 0.01, 0.05, 0.2, 0.5]
    ax.set_xticks(norm.ppf(ticks))
    ax.set_xticklabels([f"{t*100:g}" for t in ticks])
    ax.set_yticks(norm.ppf(ticks))
    ax.set_yticklabels([f"{t*100:g}" for t in ticks])
    ax.set_xlabel("False positive rate (%)")
    ax.set_ylabel("False negative rate (%)")
    ax.set_title("DET")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_score_distributions(scores: Sequence[float], labels: Sequence[int],
                             out_path: str, name: str = "model") -> str:
    plt = _plt()
    s, y = np.asarray(scores), np.asarray(labels)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(s[y == 1], bins=50, alpha=0.6, density=True, label="bonafide")
    ax.hist(s[y == 0], bins=50, alpha=0.6, density=True, label="spoof")
    _, thr = compute_eer(s, y)
    ax.axvline(thr, color="k", ls="--", lw=1, label=f"EER thr {thr:.2f}")
    ax.set_xlabel("CM score")
    ax.set_ylabel("density")
    ax.set_title(f"Score distributions — {name}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_model_comparison(per_model: Dict[str, Dict[str, float]], out_path: str,
                          metric: str = "eer") -> str:
    """Baseline-vs-FMSL paired bars (maze_models_comparison.png analog)."""
    plt = _plt()
    bases = sorted(m for m in per_model if not m.endswith("_fmsl"))
    fig, ax = plt.subplots(figsize=(max(6, len(bases) * 1.2), 4))
    xs = np.arange(len(bases))
    base_v = [per_model[b][metric] for b in bases]
    fmsl_v = [per_model.get(f"{b}_fmsl", {}).get(metric, np.nan) for b in bases]
    ax.bar(xs - 0.2, base_v, width=0.4, label="baseline")
    ax.bar(xs + 0.2, fmsl_v, width=0.4, label="+FMSL")
    ax.set_xticks(xs)
    ax.set_xticklabels(bases, rotation=30)
    ax.set_ylabel(metric.upper())
    ax.set_title(f"Baseline vs FMSL — {metric}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _paired_eer_bars(ax, per_model: Dict[str, Dict[str, float]],
                     metric: str = "eer"):
    """Paired baseline/FMSL bars with midpoint improvement annotations (the shared
    body of the reference's trend/histogram panels,
    comprehensive_thesis_analyser.py:406,461 — here driven by REAL metrics, never
    its np.random-synthesised series)."""
    bases = sorted(m for m in per_model
                   if not m.endswith("_fmsl") and f"{m}_fmsl" in per_model)
    xs = np.arange(len(bases))
    base_v = np.asarray([per_model[b][metric] for b in bases], dtype=float)
    fmsl_v = np.asarray([per_model[f"{b}_fmsl"][metric] for b in bases], dtype=float)
    b1 = ax.bar(xs - 0.2, base_v, width=0.4, label="Baseline", alpha=0.85)
    b2 = ax.bar(xs + 0.2, fmsl_v, width=0.4, label="FMSL Enhanced", alpha=0.85)
    for i, (bv, fv) in enumerate(zip(base_v, fmsl_v)):
        if bv > 0:
            ax.text(i, (bv + fv) / 2, f"{(bv - fv) / bv * 100:.1f}%",
                    ha="center", va="center", fontweight="bold",
                    bbox=dict(boxstyle="round,pad=0.2", facecolor="white",
                              alpha=0.85))
    for bars, vals in [(b1, base_v), (b2, fmsl_v)]:
        for bar, v in zip(bars, vals):
            ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                    f"{v:.3f}", ha="center", va="bottom", fontsize=8)
    ax.set_xticks(xs)
    ax.set_xticklabels([b.upper() for b in bases], rotation=30)
    ax.set_ylabel(metric.upper())
    ax.grid(True, alpha=0.3, axis="y")
    ax.set_axisbelow(True)
    ax.legend(loc="upper right")
    return bases, base_v, fmsl_v, (b1, b2)


def plot_fmsl_trend(per_model: Dict[str, Dict[str, float]], out_path: str,
                    metric: str = "eer") -> str:
    """Trend panel (create_trend_visualizations, comprehensive_thesis_analyser.py:406)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(per_model) // 2), 6))
    _paired_eer_bars(ax, per_model, metric)
    ax.set_xlabel("Model architecture")
    ax.set_title("Performance trends: FMSL enhancement")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_performance_landscape(per_model: Dict[str, Dict[str, float]],
                               out_path: str, metric: str = "eer") -> str:
    """Landscape histogram with best-performer highlights
    (create_comprehensive_histogram, comprehensive_thesis_analyser.py:461)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(9, 1.8 * len(per_model) // 2), 6))
    bases, base_v, fmsl_v, (b1, b2) = _paired_eer_bars(ax, per_model, metric)
    if len(bases):
        ib = int(np.argmin(base_v))
        jf = int(np.argmin(fmsl_v))
        b1[ib].set_edgecolor("navy")
        b1[ib].set_linewidth(2.5)
        b2[jf].set_edgecolor("goldenrod")
        b2[jf].set_linewidth(2.5)
        ax.text(ib, base_v[ib], "★ best baseline", ha="center",
                va="bottom", color="navy", fontweight="bold", fontsize=9)
        ax.text(jf, fmsl_v[jf], "★ best overall", ha="center",
                va="bottom", color="goldenrod", fontweight="bold", fontsize=9)
    ax.set_xlabel("Model architecture")
    ax.set_title("Complete performance landscape")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_embedding_geometry(features: np.ndarray, labels: Sequence[int],
                            out_path: str,
                            prototypes: Optional[np.ndarray] = None,
                            class_weights: Optional[np.ndarray] = None,
                            title: str = "Embedding geometry") -> str:
    """Real-data embedding-geometry panel: PCA projection of the pooled
    embeddings colored by class, plus a class-separation histogram.

    This replaces the reference analyzer's t-SNE/bottleneck panels, which were
    SYNTHESISED from np.random rather than model outputs
    (comprehensive_thesis_analyser.py:315-366) — here the geometry is computed
    from actual per-utterance features (cli.evaluate --dump_embeddings). For
    FMSL models the learned spoof prototypes / class weight vectors are
    projected into the same PCA plane.
    """
    plt = _plt()
    feats = np.asarray(features, dtype=np.float64)
    y = np.asarray(labels)
    mu = feats.mean(axis=0)
    xc = feats - mu
    # PCA via SVD (no sklearn dependency)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    p2 = xc @ vt[:2].T                                   # (N, 2)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 6))
    for cls, name, color in ((1, "bonafide", "tab:blue"), (0, "spoof", "tab:red")):
        m = y == cls
        ax1.scatter(p2[m, 0], p2[m, 1], s=8, alpha=0.5, c=color, label=name)
    for arr, marker, name in ((prototypes, "*", "spoof prototypes"),
                              (class_weights, "X", "class weights")):
        if arr is not None and len(arr):
            q = (np.asarray(arr, dtype=np.float64) - mu) @ vt[:2].T
            ax1.scatter(q[:, 0], q[:, 1], s=220, marker=marker, c="black",
                        edgecolors="white", linewidths=1.2, label=name, zorder=5)
    ax1.set_xlabel("PC 1")
    ax1.set_ylabel("PC 2")
    ax1.set_title(f"{title}: PCA of pooled embeddings")
    ax1.legend()

    # separation histogram: cosine to the bonafide centroid
    norm = np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12
    unit = feats / norm
    centroid = unit[y == 1].mean(axis=0) if (y == 1).any() else unit.mean(axis=0)
    centroid = centroid / (np.linalg.norm(centroid) + 1e-12)
    cos = unit @ centroid
    bins = np.linspace(float(cos.min()), float(cos.max()) + 1e-9, 40)
    ax2.hist(cos[y == 1], bins=bins, alpha=0.6, color="tab:blue",
             label="bonafide", density=True)
    ax2.hist(cos[y == 0], bins=bins, alpha=0.6, color="tab:red",
             label="spoof", density=True)
    ax2.set_xlabel("cosine similarity to bonafide centroid")
    ax2.set_ylabel("density")
    ax2.set_title("Class separation on the hypersphere")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_training_curves(curves_by_run, out_path: str) -> str:
    """Training-curve panels from the JSONL metric logs (the figure half of the
    reference's tensorboardX logging, maze2.py:487-489 / maze6.py:723-727).

    ``curves_by_run``: {run_name: {tag: [(step, value), ...]}} — the shape
    ``adfmsl_torch.utils.read_metrics`` returns, one dict per run/log dir.
    """
    plt = _plt()
    tags = sorted({t for c in curves_by_run.values() for t in c})
    if not tags:
        raise ValueError("no logged scalars found")
    fig, axes = plt.subplots(1, len(tags), figsize=(5.5 * len(tags), 4.5),
                             squeeze=False)
    for ax, tag in zip(axes[0], tags):
        for run, curves in curves_by_run.items():
            # dedupe per step, LAST record wins: resumed/re-run training
            # appends to the same metrics.jsonl (MetricsLogger opens 'a')
            pts = sorted(dict(sorted(curves.get(tag, []))).items())
            if pts:
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        marker="o", markersize=3, label=run)
        ax.set_title(tag)
        ax.set_xlabel("epoch")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
