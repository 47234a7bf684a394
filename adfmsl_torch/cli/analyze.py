"""Analysis CLI of the port: score aggregation + tables + reference comparison.

    python -m adfmsl_torch.cli.analyze --scores_dir S --protocol P \
        [--output_dir O] [--figures] [--regression TOL] \
        [--embeddings E.npz ...] [--curves LOG_DIR ...]

Port of ``adfmsl/cli/analyze.py``, with its flags, output files, printed lines
and return codes (1: no score files under ``--scores_dir``; 2: a model
outside ``--regression``'s tolerance of its published EER). Replaces
score_file_processor.py's __main__ and the table half of
comprehensive_thesis_analyser.py (SURVEY.md 2.6). Host-only: it reads score
files, ``cli.evaluate --dump_embeddings`` dumps and ``cli.train --log_dir``
metric logs; matplotlib (Agg) is imported only for the figures."""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.analyze")
    p.add_argument("--scores_dir", default=None,
                   help="directory of *_scores.txt (required unless only "
                        "--embeddings panels are requested)")
    p.add_argument("--protocol", default=None,
                   help="CM protocol with labels (required for everything "
                        "except --curves-only runs)")
    p.add_argument("--output_dir", default="analysis_out")
    p.add_argument("--polarity", default="bonafide1", choices=["bonafide1", "spoof1"])
    p.add_argument("--asv_scores", default=None, metavar="FILE",
                   help="organizers' ASV score file for the official min t-DCF "
                        "operating point")
    p.add_argument("--figures", action="store_true",
                   help="render the full figure panel set (ROC/DET/score dists/"
                        "comparison/trend/landscape) from the real scores")
    p.add_argument("--regression", type=float, default=None, metavar="TOL",
                   help="fail (rc 2) unless every model with a published thesis "
                        "EER is within TOL absolute (target: 0.001)")
    p.add_argument("--curves", default=None, metavar="LOG_DIR", action="append",
                   help="JSONL metric log dir(s) from cli.train --log_dir; "
                        "renders training-curve panels per logged tag")
    p.add_argument("--embeddings", default=None, metavar="NPZ", action="append",
                   help="embedding dump(s) from cli.evaluate --dump_embeddings; "
                        "renders real-data PCA geometry + hypersphere "
                        "separation panels (the reference analyzer synthesised "
                        "these from np.random)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.scores_dir or args.embeddings) and not args.protocol:
        parser.error("--protocol is required with --scores_dir/--embeddings")
    if not args.scores_dir:
        if not (args.embeddings or args.curves):
            parser.error("--scores_dir is required (or pass --embeddings/"
                         "--curves)")
        os.makedirs(args.output_dir, exist_ok=True)
        if args.embeddings:
            _render_embeddings(args)
        if args.curves:
            _render_curves(args)
        return 0
    from adfmsl_torch.analysis import (
        ScoreFileProcessor,
        comparison_markdown,
        results_csv,
        results_latex,
    )

    proc = ScoreFileProcessor(args.scores_dir, args.protocol, args.polarity,
                              asv_scores=args.asv_scores)
    processed = proc.process_all_scores()
    if not processed.per_model:
        print("no score files found under", args.scores_dir)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    proc.export_for_thesis_analysis(
        processed, os.path.join(args.output_dir, "processed_performance_data.json"))
    with open(os.path.join(args.output_dir, "results.csv"), "w") as fh:
        fh.write(results_csv(processed.per_model))
    with open(os.path.join(args.output_dir, "results.tex"), "w") as fh:
        fh.write(results_latex(processed.per_model))
    with open(os.path.join(args.output_dir, "report.md"), "w") as fh:
        fh.write(comparison_markdown(processed.per_model))
    print(processed.summary())
    print(f"\nwrote JSON/CSV/LaTeX/markdown to {args.output_dir}/")

    if args.figures:
        _render_figures(args, processed)
    if args.embeddings:
        _render_embeddings(args)
    if args.curves:
        _render_curves(args)

    if args.regression is not None:
        from adfmsl_torch.analysis import check_against_reference

        checked = check_against_reference(processed.per_model,
                                          tol_eer=args.regression)
        bad = 0
        for name in sorted(checked):
            r = checked[name]
            status = "PASS" if r["within"] else "FAIL"
            bad += not r["within"]
            print(f"regression {status}: {name} EER {r['eer']:.4f} vs "
                  f"ref {r['ref_eer']:.4f} (delta {r['delta']:+.4f})")
        if not checked:
            print("regression: no models with published reference numbers")
        if bad:
            return 2
    return 0


def _render_figures(args, processed) -> None:
    from adfmsl_torch.analysis import (plot_det, plot_fmsl_trend, plot_model_comparison,
                                 plot_performance_landscape, plot_roc,
                                 plot_score_distributions)
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.evaluation.scores import join_scores_with_labels, read_score_file

    labels = parse_protocol(args.protocol, args.polarity).labels
    sb, lb = {}, {}
    for name, m in processed.per_model.items():
        if "score_file" not in m:
            continue
        s, y, _ = join_scores_with_labels(read_score_file(m["score_file"]), labels)
        sb[name], lb[name] = s, y
        plot_score_distributions(
            s, y, os.path.join(args.output_dir, f"{name}_score_dist.png"), name)
    if sb:
        plot_roc(sb, lb, os.path.join(args.output_dir, "roc.png"))
        plot_det(sb, lb, os.path.join(args.output_dir, "det.png"))
    plot_model_comparison(processed.per_model,
                          os.path.join(args.output_dir, "model_comparison.png"))
    # the paired panels need at least one (base, base_fmsl) pair — a lone
    # *_fmsl score file would otherwise render blank bar charts
    if any(n.endswith("_fmsl") and n[:-5] in processed.per_model
           for n in processed.per_model):
        plot_fmsl_trend(processed.per_model,
                        os.path.join(args.output_dir, "trend_visualizations.png"))
        plot_performance_landscape(
            processed.per_model,
            os.path.join(args.output_dir, "comprehensive_histogram.png"))
    print(f"wrote figure panels to {args.output_dir}/")


def _render_embeddings(args) -> None:
    import numpy as np

    from adfmsl_torch.analysis import plot_embedding_geometry
    from adfmsl_torch.data import parse_protocol

    labels = parse_protocol(args.protocol, args.polarity).labels
    for path in args.embeddings:
        with np.load(path, allow_pickle=False) as z:
            utt_ids = [str(u) for u in z["utt_ids"]]
            feats = z["features"]
            protos = z["prototypes"] if "prototypes" in z.files else None
            weights = z["class_weights"] if "class_weights" in z.files else None
        keep = [i for i, u in enumerate(utt_ids) if u in labels]
        if not keep:
            print(f"embeddings {path}: no utterances match the protocol")
            continue
        # the figure's class names assume canonical bonafide=1 — flip the
        # 'spoof1' compat polarity back before plotting
        flip = args.polarity == "spoof1"
        y = [1 - labels[utt_ids[i]] if flip else labels[utt_ids[i]]
             for i in keep]
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"embedding_geometry_{name}.png")
        plot_embedding_geometry(feats[keep], y, out, prototypes=protos,
                                class_weights=weights, title=name)
        print(f"wrote {out}")


def _render_curves(args) -> None:
    from adfmsl_torch.analysis import plot_training_curves
    from adfmsl_torch.utils import read_metrics

    curves = {}
    names = [os.path.basename(os.path.normpath(d)) or d for d in args.curves]
    for d, name in zip(args.curves, names):
        if names.count(name) > 1:          # runs/maze4/logs vs runs/maze5/logs
            name = os.path.normpath(d)
        c = read_metrics(d)
        if c:
            curves[name] = c
        else:
            print(f"curves: no metrics.jsonl under {d}")
    if curves:
        out = os.path.join(args.output_dir, "training_curves.png")
        plot_training_curves(curves, out)
        print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
