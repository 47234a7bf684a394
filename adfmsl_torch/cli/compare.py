"""Comparison CLI of the port: two-model head-to-head from score files.

    python -m adfmsl_torch.cli.compare --scores_a A --scores_b B --protocol P \
        [--name_a N --name_b M] [--output_dir O] [--n_resamples 1000] [--no_figures]

Port of ``adfmsl/cli/compare.py``: writes ``comparison.md`` and the ROC, DET
and both score-distribution figures.

Rebuild of ``comprehensive_evaluation.py``'s CLI surface (``run_dual_model_evaluation``,
Maze6_Eval.py:669): paired metrics, bootstrap significance, diagnostics, markdown
report, and ROC/DET/score-distribution figures.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.compare")
    p.add_argument("--scores_a", required=True)
    p.add_argument("--scores_b", required=True)
    p.add_argument("--name_a", default=None)
    p.add_argument("--name_b", default=None)
    p.add_argument("--protocol", required=True)
    p.add_argument("--output_dir", default="comparison_out")
    p.add_argument("--n_resamples", type=int, default=1000)
    p.add_argument("--no_figures", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from adfmsl_torch.analysis import (
        compare_models,
        plot_det,
        plot_roc,
        plot_score_distributions,
    )
    from adfmsl_torch.analysis.processor import model_name_from_filename
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.evaluation import read_score_file

    name_a = args.name_a or model_name_from_filename(args.scores_a) or "model_a"
    name_b = args.name_b or model_name_from_filename(args.scores_b) or "model_b"
    sa, sb = read_score_file(args.scores_a), read_score_file(args.scores_b)
    labels = parse_protocol(args.protocol).labels

    res = compare_models(sa, sb, labels, name_a, name_b, args.n_resamples)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "comparison.md"), "w") as fh:
        fh.write(res.markdown())
    print(res.markdown())

    if not args.no_figures:
        common = sorted(set(sa) & set(sb) & set(labels))
        y = np.asarray([labels[u] for u in common])
        by_model = {name_a: np.asarray([sa[u] for u in common]),
                    name_b: np.asarray([sb[u] for u in common])}
        lab_by = {name_a: y, name_b: y}
        plot_roc(by_model, lab_by, os.path.join(args.output_dir, "roc.png"))
        plot_det(by_model, lab_by, os.path.join(args.output_dir, "det.png"))
        plot_score_distributions(by_model[name_a], y,
                                 os.path.join(args.output_dir, f"{name_a}_dist.png"),
                                 name_a)
        plot_score_distributions(by_model[name_b], y,
                                 os.path.join(args.output_dir, f"{name_b}_dist.png"),
                                 name_b)
        print(f"figures written to {args.output_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
