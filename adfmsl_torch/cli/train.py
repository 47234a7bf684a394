"""Training CLI of the port (port of ``adfmsl/cli/train.py``, :13-190).

    python -m adfmsl_torch.cli.train --model maze5 | --config Y.yaml \\
        --train_protocol P --train_dir D [--dev_protocol P2 --dev_dir D2] \\
        --batch_size 12 --num_epochs N --checkpoint_dir C [--restore] \\
        [--log_dir L] [--profile_dir T] [--device cuda|cpu] \\
        [--train_pack PK --dev_pack PK2 --eval_pack PK3] \\
        [--data_parallel N --dist_backend nccl|gloo]

Trains a registry model from its standardized configuration, or from the
``ExperimentConfig`` YAML of ``--config`` (``config/yaml_io.py``; the
``--batch_size`` / ``--lr`` / ``--num_epochs`` / ``--seed`` and path flags
override it, and a path left unset keeps the YAML's), one checkpoint per
epoch under ``C`` (best-k retention) with the config beside them as
``C/experiment.yaml``; ``--restore`` continues from the latest one. As
adfmsl's CLI, it has no flag for the fused kernels: a YAML's ``model.extra``
sets them (``fused_train_frontend``: kernel K3 and its backward in RawNet's
train forward; ``fused_eval_trunk``: K1 under ``--eval``).
``python -m adfmsl_torch.cli.evaluate --model_path C`` scores with the latest
epoch. ``--eval`` writes a score file for ``--eval_protocol`` instead of
training, and leaves ``C/experiment.yaml`` as it was. ``--log_dir`` writes
each epoch's ``train/loss``, ``train/acc`` and ``dev/acc`` at step = epoch
to ``L/metrics.jsonl`` (``utils/metrics_log.py``); ``--profile_dir`` traces
the first epoch with ``torch.profiler`` into ``T`` and trains the rest
untraced; every training run ends by logging the Trainer's step timer. Runs
on the card unless ``--device cpu`` is given.

``--train_pack`` / ``--dev_pack`` / ``--eval_pack`` read a split from a pack
of ``python -m adfmsl_torch.cli.pack`` instead of decoding its audio dir (adfmsl
:105-121, :164-167): the split's protocol is parsed first and gives the labels,
the batches are those of the audio path, and the train pack's clip length
becomes ``exp.data.cut`` before the Trainer is built (``experiment.yaml``
records it).

``--data_parallel N`` (N > 1) trains data-parallel over N local ranks
(``parallel/launch.py``: one process each, rank r on card r): each rank
decodes its row block of every global batch, BatchNorm and the loss are
those of the global batch, rank 0 writes the checkpoints. ``--dist_backend``
is ``nccl`` (one card a rank; more ranks than cards raises) or ``gloo``
(ranks may share a card, or run on the CPU with ``--device cpu``). The run
has no time limit; a collective that waits ``--dist_timeout`` seconds fails
its rank, and a failed rank fails the run. Each rank prints a
``rank_summary`` JSON line with its kernel launches. Rank 0 alone writes
``experiment.yaml`` and ``metrics.jsonl``; with ``--profile_dir`` every rank
writes its own trace (named by host and process id).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adfmsl_torch.cli.train")
    p.add_argument("--model", default="maze5", help="registry model name")
    p.add_argument("--config", default=None, help="YAML ExperimentConfig path")
    p.add_argument("--database_path", default=None)
    p.add_argument("--protocols_path", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--track", default="LA", choices=["LA", "PA", "DF"])
    p.add_argument("--eval", action="store_true", help="produce score file and exit")
    p.add_argument("--eval_output", default="scores.txt")
    p.add_argument("--eval_protocol", default=None)
    p.add_argument("--eval_dir", default=None)
    p.add_argument("--train_protocol", default=None)
    p.add_argument("--train_dir", default=None)
    p.add_argument("--dev_protocol", default=None)
    p.add_argument("--dev_dir", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--restore", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint_dir")
    p.add_argument("--no_drift", action="store_true",
                   help="use canonical FMSL params instead of reference drift")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--log_dir", default=None,
                   help="JSONL scalar metrics directory (tensorboardX analog)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="train over N local ranks (0 / 1: one process)")
    p.add_argument("--dist_backend", default="nccl", choices=["nccl", "gloo"],
                   help="the ranks' torch.distributed backend (gloo: ranks may "
                        "share a card or run on the CPU)")
    p.add_argument("--dist_timeout", type=float, default=1800.0,
                   help="seconds a collective may wait for the other ranks before "
                        "its rank fails (the run itself has no time limit)")
    p.add_argument("--train_pack", default=None,
                   help="pack prefix (cli.pack) replacing the train audio dir")
    p.add_argument("--dev_pack", default=None)
    p.add_argument("--eval_pack", default=None,
                   help="pack prefix for the --eval protocol split")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _default_paths(exp, split: str, tag: str):
    track = exp.data.track
    proto = os.path.join(exp.data.protocols_path, f"ASVspoof2019.{track}.cm.{split}.{tag}.txt")
    audio = os.path.join(exp.data.database_path, f"ASVspoof2019_{track}_{split}")
    return proto, audio


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.data_parallel > 1:
        from adfmsl_torch.parallel import launch

        launch(_rank_main, args.data_parallel, (argv if argv is not None else sys.argv[1:],),
               backend=args.dist_backend, device=args.device,
               collective_timeout=args.dist_timeout)
        return 0
    return run(args, args.device)


def _rank_main(device, argv) -> None:
    """One rank of ``--data_parallel``."""
    from adfmsl_torch.config import MeshConfig
    from adfmsl_torch.parallel import kernel_launches, make_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    mesh = make_mesh(MeshConfig(data_parallel=args.data_parallel), args.data_parallel)
    run(args, device, mesh)
    print("rank_summary " + json.dumps({"rank": mesh.rank, "device": str(device),
                                        "kernel_launches": kernel_launches()}), flush=True)


def run(args, device, mesh=None) -> int:
    """Train (or with ``--eval`` score) as the parsed ``args`` say, on
    ``device``; under ``mesh`` as this rank."""
    from adfmsl_torch.config import load_yaml, make_experiment
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.evaluation import evaluate_to_file
    from adfmsl_torch.train import Trainer, make_dataset_and_loader

    if args.config:
        exp = load_yaml(args.config)
    else:
        exp = make_experiment(args.model, drift=not args.no_drift)
    for flag, obj, field in [("batch_size", exp.train, "batch_size"),
                             ("lr", exp.train.optimizer, "lr"),
                             ("num_epochs", exp.train, "num_epochs"),
                             ("seed", exp.train, "seed")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(obj, field, v)
    exp.data.database_path = args.database_path or exp.data.database_path or "data/"
    exp.data.protocols_path = args.protocols_path or exp.data.protocols_path or "protocols/"
    exp.data.track = args.track

    train_proto_path = args.train_protocol or _default_paths(exp, "train", "trn")[0]
    train_dir = args.train_dir or _default_paths(exp, "train", "trn")[1]
    dev_proto_path = args.dev_protocol or _default_paths(exp, "dev", "trl")[0]
    dev_dir = args.dev_dir or _default_paths(exp, "dev", "trl")[1]

    shard = ({"rank": mesh.data_rank, "world": mesh.dp} if mesh is not None else {})
    train_proto = parse_protocol(train_proto_path, exp.data.label_polarity)
    train_loader = make_dataset_and_loader(exp, train_proto, train_dir, shuffle=True,
                                           pack=args.train_pack, **shard)
    if train_loader.ds.cut != exp.data.cut:
        logging.info("clip length from pack: %d", train_loader.ds.cut)
        exp.data.cut = train_loader.ds.cut
    dev_loader = None
    if args.dev_pack or os.path.exists(dev_proto_path):
        dev_proto = parse_protocol(dev_proto_path, exp.data.label_polarity)
        dev_loader = make_dataset_and_loader(exp, dev_proto, dev_dir, shuffle=False,
                                             batch_size=exp.train.eval_batch_size,
                                             drop_last=False, pack=args.dev_pack, **shard)

    with contextlib.ExitStack() as stack:
        metric_hook = None
        if args.log_dir and (mesh is None or mesh.rank == 0):
            from adfmsl_torch.utils import MetricsLogger

            mlog = stack.enter_context(contextlib.closing(MetricsLogger(args.log_dir)))

            def metric_hook(em):
                mlog.add_scalars({"train/loss": em.train_loss, "train/acc": em.train_acc,
                                  "dev/acc": em.dev_acc}, em.epoch)

        trainer = Trainer(exp, train_loader, dev_loader,
                          checkpoint_dir=args.checkpoint_dir, metric_hook=metric_hook,
                          mesh=mesh, device=device, persist_config=not args.eval)
        if args.restore and args.checkpoint_dir:
            epoch = trainer.restore()
            logging.info("restored checkpoint epoch %d", epoch)

        if args.eval:
            eval_proto_path = args.eval_protocol or _default_paths(exp, "eval", "trl")[0]
            eval_dir = args.eval_dir or _default_paths(exp, "eval", "trl")[1]
            eval_proto = parse_protocol(eval_proto_path, exp.data.label_polarity)
            loader = make_dataset_and_loader(exp, eval_proto, eval_dir, shuffle=False,
                                             batch_size=exp.train.eval_batch_size,
                                             drop_last=False, pack=args.eval_pack, **shard)
            trainer.state.model.eval()
            res = evaluate_to_file(trainer.state.model, loader, args.eval_output,
                                   labels=eval_proto.labels or None, mesh=mesh)
            if res.metrics and (mesh is None or mesh.rank == 0):
                print({k: round(v, 6) if isinstance(v, float) else v
                       for k, v in res.metrics.items()})
            return 0

        if args.profile_dir:
            from adfmsl_torch.utils import trace

            with trace(args.profile_dir):
                trainer.fit(num_epochs=1)
            trainer.fit(num_epochs=max(exp.train.num_epochs - 1, 0))
        else:
            trainer.fit()
    logging.info("step timing:\n%s", trainer.timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
