"""Few-shot CLI of the port: episodic meta-training, K-shot adaptation to a
new domain, and scoring of its held-out utterances.

    python -m adfmsl_torch.cli.fewshot --model maze5 \
        --train_protocol .../train.trn.txt --train_dir .../flac \
        --adapt_protocol .../eval.trl.txt --adapt_dir .../flac \
        --k_shot 5 --n_steps 100 --output scores.txt [--device cuda]

Port of ``adfmsl/cli/fewshot.py``, flag for flag, plus ``--device`` (the
card unless ``--device cpu`` is given). The eval-mode embeds (adaptation and
scoring) run the folded trunk (``extra.fused_eval_trunk``: K1 on the card)
unless ``--no_fused_trunk`` is given or the config promises f32 or
reference-parity numerics; the meta step embeds in train mode and is not
affected. The K support utterances of each class are left out of the score
file and the metrics.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.fewshot")
    p.add_argument("--model", default="maze5")
    p.add_argument("--train_protocol", required=True)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--adapt_protocol", required=True,
                   help="labelled protocol of the target domain; K support "
                        "utterances per class are drawn from it, the rest scored")
    p.add_argument("--adapt_dir", required=True)
    p.add_argument("--n_way", type=int, default=2)
    p.add_argument("--k_shot", type=int, default=5)
    p.add_argument("--q_queries", type=int, default=5)
    p.add_argument("--episodes_per_batch", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cut", type=int, default=None)
    p.add_argument("--model_path", default=None,
                   help="supervised/meta checkpoint dir to warm-start the "
                        "embedder (params + BN stats) from")
    p.add_argument("--no_fused_trunk", action="store_true",
                   help="run the eval-mode embeds (adaptation + scoring) through "
                        "the unfolded trunk instead of the K1 kernel")
    p.add_argument("--output", default="fewshot_scores.txt")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import AsvspoofDataset, parse_protocol
    from adfmsl_torch.evaluation import compute_all_metrics, write_score_file
    from adfmsl_torch.models import SPECS
    from adfmsl_torch.train.fewshot import FewshotConfig, FewshotTrainer

    exp = make_experiment(args.model)
    if args.cut:
        exp.data.cut = args.cut
    # the evaluate CLI's parity guard (adfmsl :64-68): f32 or reference-parity
    # configs keep the unfolded trunk
    spec = SPECS.get(args.model)
    if spec is not None:
        set_fused_extras(exp, spec, fused_frontend=False,
                         fused_trunk=not args.no_fused_trunk)
    fcfg = FewshotConfig(args.n_way, args.k_shot, args.q_queries,
                         args.episodes_per_batch, args.n_steps, lr=args.lr)

    train_proto = parse_protocol(args.train_protocol, exp.data.label_polarity)
    train_ds = AsvspoofDataset(train_proto, args.train_dir, cut=exp.data.cut,
                               pad_mode=exp.data.pad_mode)
    trainer = FewshotTrainer(exp, fcfg, train_proto, train_ds,
                             checkpoint_dir=args.model_path, device=args.device)
    hist = trainer.fit()
    logging.info("meta-training done: final episode acc %.3f",
                 np.mean([h["acc"] for h in hist[-10:]]))

    # K-shot adaptation: draw K support utts per class from the target protocol
    adapt_proto = parse_protocol(args.adapt_protocol, exp.data.label_polarity)
    adapt_ds = AsvspoofDataset(adapt_proto, args.adapt_dir, cut=exp.data.cut,
                               pad_mode=exp.data.pad_mode)
    labels = adapt_proto.labels
    rng = np.random.default_rng(exp.train.seed)
    support, sup_labels, sup_ids = [], [], set()
    for cls in (0, 1):
        utts = [u for u in adapt_proto.utt_ids if labels.get(u) == cls]
        rng.shuffle(utts)
        for u in utts[: args.k_shot]:
            support.append(adapt_ds.load(u)[0])
            sup_labels.append(cls)
            sup_ids.add(u)
    protos = trainer.adapt(np.stack(support), np.asarray(sup_labels))
    logging.info("adapted %d-shot prototypes from %d support utts", args.k_shot,
                 len(sup_labels))

    # score and report only the held-out utterances: the K support samples
    # defined the prototypes and would score near-perfectly
    scores = {u: s for u, s in trainer.score_protocol(adapt_ds, protos).items()
              if u not in sup_ids}
    write_score_file(args.output, list(scores), list(scores.values()))
    y = np.asarray([labels[u] for u in scores])
    m = compute_all_metrics(np.asarray(list(scores.values())), y)
    m["n_support_excluded"] = len(sup_ids)
    print({k: round(v, 6) if isinstance(v, float) else v for k, v in m.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
