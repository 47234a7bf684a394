"""Batch CLI of the port: the multi-model experiment orchestrator.

    python -m adfmsl_torch.cli.batch --config PLAN.yaml --train_protocol P \\
        --train_dir D [--dev_protocol P2 --dev_dir D2] --eval_protocol P3 \\
        --eval_dir D3 [--output_dir O] [--no_drift] [--device cuda|cpu]

Port of ``adfmsl/cli/batch.py``, a rebuild of
``Thesis/06_Utilities/model_trainer.py:20-128``: the reference
subprocess-spawns each per-model training script from a YAML model list, then
runs eval scripts and prints a summary. Here the models share one process on
one device (the card unless ``--device cpu`` is given): each listed model is
trained by the ``Trainer``, its last state scores the eval protocol into
``O/scores/<model>_scores.txt`` through ``evaluate_to_file``, and the analysis
layer aggregates the score files into ``O/processed_performance_data.json``,
``O/results.csv`` and ``O/report.md``; checkpoints go to ``O/ckpts/<model>``.

YAML schema (``configs/all_models.yaml``):
  models: [maze5, maze5_fmsl, ...]
  overrides: {train.num_epochs: 2, data.cut: 16000}       # applied to every model
  per_model: {maze5_fmsl: {train.optimizer.lr: 2e-4}}     # per-model overrides

A ``model.extra`` override replaces the model's ``extra`` dict, so a plan can
turn on the kernels: ``fused_train_frontend`` (K3 and its backward kernel in
RawNet's train forward) and ``fused_eval_trunk`` (K1 in the eval forward).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.batch")
    p.add_argument("--config", required=True, help="YAML with models: [...]")
    p.add_argument("--train_protocol", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--dev_protocol", default=None)
    p.add_argument("--dev_dir", default=None)
    p.add_argument("--eval_protocol", required=True)
    p.add_argument("--eval_dir", required=True)
    p.add_argument("--output_dir", default="batch_out")
    p.add_argument("--no_drift", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _apply(exp, overrides: Dict):
    from adfmsl_torch.config.standardized import apply_overrides

    apply_overrides(exp, overrides)   # validates leaf names, deep-copies values


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import yaml

    from adfmsl_torch.analysis import ScoreFileProcessor, comparison_markdown, results_csv
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.device import resolve_device
    from adfmsl_torch.evaluation import evaluate_to_file
    from adfmsl_torch.train import Trainer, make_dataset_and_loader

    device = resolve_device(args.device)
    with open(args.config) as fh:
        plan = yaml.safe_load(fh)
    models = plan.get("models", [])
    if not models:
        print("no models listed in", args.config)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    scores_dir = os.path.join(args.output_dir, "scores")
    os.makedirs(scores_dir, exist_ok=True)

    # protocols are parsed per polarity AFTER overrides apply — a YAML
    # `data.label_polarity: spoof1` override must reach the parser
    proto_cache = {}

    def protos_for(polarity):
        if polarity not in proto_cache:
            proto_cache[polarity] = (
                parse_protocol(args.train_protocol, polarity),
                parse_protocol(args.dev_protocol, polarity)
                if args.dev_protocol else None,
                parse_protocol(args.eval_protocol, polarity))
        return proto_cache[polarity]

    last_polarity = "bonafide1"
    for name in models:
        logging.info("=== training %s ===", name)
        exp = make_experiment(name, drift=not args.no_drift)
        _apply(exp, plan.get("overrides"))
        _apply(exp, (plan.get("per_model") or {}).get(name))
        train_proto, dev_proto, eval_proto = protos_for(exp.data.label_polarity)
        last_polarity = exp.data.label_polarity
        train_loader = make_dataset_and_loader(exp, train_proto, args.train_dir,
                                               shuffle=True)
        dev_loader = None
        if dev_proto is not None:
            dev_loader = make_dataset_and_loader(
                exp, dev_proto, args.dev_dir, shuffle=False,
                batch_size=exp.train.eval_batch_size, drop_last=False)
        ckpt_dir = os.path.join(args.output_dir, "ckpts", name)
        trainer = Trainer(exp, train_loader, dev_loader, checkpoint_dir=ckpt_dir,
                          device=device)
        trainer.fit()
        eval_loader = make_dataset_and_loader(
            exp, eval_proto, args.eval_dir, shuffle=False,
            batch_size=exp.train.eval_batch_size, drop_last=False)
        model = trainer.state.model
        model.eval()
        evaluate_to_file(model, eval_loader, os.path.join(scores_dir, f"{name}_scores.txt"))

    proc = ScoreFileProcessor(scores_dir, args.eval_protocol, last_polarity)
    processed = proc.process_all_scores()
    proc.export_for_thesis_analysis(
        processed, os.path.join(args.output_dir, "processed_performance_data.json"))
    with open(os.path.join(args.output_dir, "results.csv"), "w") as fh:
        fh.write(results_csv(processed.per_model))
    with open(os.path.join(args.output_dir, "report.md"), "w") as fh:
        fh.write(comparison_markdown(processed.per_model))
    print(processed.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
