"""Evaluation CLI of the port: protocol -> score file -> EER / min-DCF / min t-DCF.

    python -m adfmsl_torch.cli.evaluate --model_type maze5|main|... --protocol P \
        --data_dir D | --pack PK [--model_path CKPT_DIR] [--fused_frontend] \
        [--device cuda] [--data_parallel N --dist_backend nccl|gloo] \
        [--dump_embeddings E.npz] [--profile_dir D] ...

Port of ``adfmsl/cli/evaluate.py``: rebuilds the architecture, loads the
checkpoint (``model.pt`` written by ``adfmsl_torch.models.save_checkpoint``;
its config from ``experiment.yaml`` beside it where there is one, as adfmsl's
CLI reads it, else from ``model.pt``) or initialises randomly from
``--seed``, optionally smoke-tests a synthetic forward pass, streams the eval
protocol, writes the score file and prints the metric dict. Runs on the card
unless ``--device cpu`` is given. ``--pack`` reads the protocol's clips from
a pack of ``python -m adfmsl_torch.cli.pack`` instead of decoding
``--data_dir`` (adfmsl :117-134); the clip length is then the pack's.

``--dump_embeddings NPZ`` (adfmsl :44-47, :154-182) also saves the pooled
embeddings of the same forward as the scores: an ``.npz`` of ``utt_ids``,
``features`` (N, D) and ``scores``, and for a model with an FMSL head its
``prototypes`` and ``class_weights``, each row divided by its norm + 1e-12
(``python -m adfmsl_torch.cli.analyze --embeddings`` reads it).

``--data_parallel N`` (N > 1) scores over N local ranks (``parallel/launch.py``;
``--dist_backend`` and ``--dist_timeout`` as in ``cli/train.py``): rank 0's
weights are broadcast, each rank decodes and scores its row block of every
batch, and rank 0 writes the score file (and the ``--dump_embeddings`` file), equal to
the one-process file. Each rank prints a
``rank_summary`` JSON line (its kernel launches and the port's counters:
``host_syncs``, ``loader.*``; ``utils/profiling.py``).

``--profile_dir D`` writes a ``torch.profiler`` Chrome trace of the scoring
(``D/<host>_<pid>.pt.trace.json``, one a rank) that holds the port's spans:
``stage.model.*``, ``stage.k1.weights``, ``stage.loader.get``,
``stage.runner.drain``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.evaluate")
    p.add_argument("--model_type", required=True, help="registry model name")
    p.add_argument("--model_path", default=None,
                   help="checkpoint dir holding model.pt (optional: random init)")
    p.add_argument("--protocol", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--pack", default=None,
                   help="pack prefix (cli.pack) replacing --data_dir: no decode "
                        "during evaluation")
    p.add_argument("--output", default=None, help="score file path")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--cut", type=int, default=None,
                   help="override fixed clip length in samples (default 64600)")
    p.add_argument("--no_drift", action="store_true")
    p.add_argument("--fused_frontend", action="store_true",
                   help="run the RawNet front end through the K3 kernel at "
                        "batches of at most 16 (rawnet models)")
    p.add_argument("--no_fused_frontend", action="store_true",
                   help="(compatibility no-op: the fused front end is opt-in)")
    p.add_argument("--no_fused_trunk", action="store_true",
                   help="run the trunk unfolded instead of through the K1 kernel")
    p.add_argument("--smoke_test", action="store_true",
                   help="synthetic forward-pass check before evaluation")
    p.add_argument("--dump_embeddings", default=None, metavar="NPZ",
                   help="also save per-utterance pooled embeddings (+ FMSL "
                        "prototypes/class weights when present) for "
                        "cli.analyze --embeddings")
    p.add_argument("--asv_scores", default=None, metavar="FILE",
                   help="organizers' ASV score file (target/nontarget/spoof "
                        "keys): derives the ASV operating point so min_tdcf "
                        "is the OFFICIAL computation")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the scoring pass here, "
                        "with the port's stage spans")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when no --model_path is given")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="score over N local ranks (0 / 1: one process)")
    p.add_argument("--dist_backend", default="nccl", choices=["nccl", "gloo"],
                   help="the ranks' torch.distributed backend (gloo: ranks may "
                        "share a card or run on the CPU)")
    p.add_argument("--dist_timeout", type=float, default=1800.0,
                   help="seconds a collective may wait for the other ranks before "
                        "its rank fails (the run itself has no time limit)")
    return p


def smoke_test(model, cut: int) -> bool:
    """Synthetic forward (Maze5_eval.py:269-320 analog): shapes + finiteness."""
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, cut)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        scores = model(x)["scores"].float().cpu().numpy()
    ok = scores.shape == (2,) and bool(np.isfinite(scores).all())
    logging.info("smoke test %s: scores %s", "OK" if ok else "FAILED", scores)
    return ok


def set_fused_extras(exp, spec, fused_frontend: bool, fused_trunk: bool) -> None:
    """adfmsl's rule (cli/evaluate.py:105-115) for the eval kernels: the K3
    front end of a RawNet model if ``fused_frontend``, the folded K1 trunk if
    ``fused_trunk``; neither when the config promises f32 or reference-parity
    numerics."""
    model = exp.model
    parity = (model.architecture.block_semantics == "reference"
              or model.architecture.sinc_formula == "reference"
              or model.dtype == "float32")
    if spec.frontend == "rawnet":
        model.extra["fused_eval_frontend"] = fused_frontend and not parity
    if spec.blocks or spec.frontend == "rawnet":
        model.extra["fused_eval_trunk"] = fused_trunk and not parity


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.data_dir or args.pack):
        parser.error("one of --data_dir or --pack is required")
    if args.data_parallel > 1:
        from adfmsl_torch.parallel import launch

        rcs = launch(_rank_main, args.data_parallel,
                     (argv if argv is not None else sys.argv[1:],),
                     backend=args.dist_backend, device=args.device,
                     collective_timeout=args.dist_timeout)
        return max(rcs)
    return run(parser, args, args.device)


def _rank_main(device, argv) -> int:
    """One rank of ``--data_parallel``."""
    from adfmsl_torch.config import MeshConfig
    from adfmsl_torch.parallel import kernel_launches, make_mesh
    from adfmsl_torch.utils.profiling import totals

    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh = make_mesh(MeshConfig(data_parallel=args.data_parallel), args.data_parallel)
    rc = run(parser, args, device, mesh)
    print("rank_summary " + json.dumps({"rank": mesh.rank, "device": str(device),
                                        "kernel_launches": kernel_launches(),
                                        "counters": totals()}), flush=True)
    return rc


def run(parser, args, device, mesh=None) -> int:
    """Score as the parsed ``args`` say on ``device``; under ``mesh`` as this
    rank."""
    from adfmsl_torch.config import load_yaml, make_experiment
    from adfmsl_torch.data import AsvspoofDataset, DataLoader, PackedDataset, parse_protocol
    from adfmsl_torch.device import resolve_device
    from adfmsl_torch.evaluation import evaluate_to_file
    from adfmsl_torch.models import SPECS, build_model, load_checkpoint

    device = resolve_device(device)
    state = None
    if args.model_path:
        # the config beside the checkpoints first (adfmsl's Trainer and the
        # port's write it), else the one each model.pt carries
        exp, state = load_checkpoint(args.model_path)
        source = os.path.join(args.model_path, "experiment.yaml")
        if os.path.exists(source):
            exp = load_yaml(source)
        else:
            source = args.model_path
        if exp.model.name != args.model_type:
            parser.error(f"--model_type {args.model_type} but the checkpoint "
                         f"holds {exp.model.name}")
        logging.info("loaded experiment config from %s", source)
    else:
        exp = make_experiment(args.model_type, drift=not args.no_drift)
    if args.cut:
        exp.data.cut = args.cut
    proto = parse_protocol(args.protocol, exp.data.label_polarity)
    if args.pack:
        ds = PackedDataset(args.pack, proto)
        if ds.cut != exp.data.cut:
            (logging.warning if args.cut else logging.info)(
                "clip length comes from the pack: %d (config had %d%s)",
                ds.cut, exp.data.cut,
                " — the explicit --cut is overridden" if args.cut else "")
            exp.data.cut = ds.cut
    else:
        ds = AsvspoofDataset(proto, args.data_dir, cut=exp.data.cut,
                             pad_mode=exp.data.pad_mode, sample_rate=exp.data.sample_rate,
                             use_native_io=exp.data.use_native_io,
                             num_workers=exp.data.num_workers)
    spec = SPECS.get(args.model_type)
    if spec is not None:
        set_fused_extras(exp, spec,
                         fused_frontend=args.fused_frontend and not args.no_fused_frontend,
                         fused_trunk=not args.no_fused_trunk)
    model = build_model(exp.model, device=device, seed=args.seed)
    if state is not None:
        model.load_state_dict(state, strict=True)
    if mesh is not None:
        from adfmsl_torch.parallel import replicate

        replicate(mesh, model)
    shard = ({"rank": mesh.data_rank, "world": mesh.dp} if mesh is not None else {})
    loader = DataLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                        prefetch=exp.data.prefetch, **shard)
    if args.smoke_test and not smoke_test(model, exp.data.cut):
        return 1
    out_path = args.output or f"{args.model_type}_scores.txt"
    with contextlib.ExitStack() as stack:
        if args.profile_dir:
            from adfmsl_torch.utils import trace

            stack.enter_context(trace(args.profile_dir))
        # with --dump_embeddings the features ride the same forward as the scores
        res = evaluate_to_file(model, loader, out_path, labels=proto.labels or None,
                               asv_scores=args.asv_scores, mesh=mesh,
                               collect_features=bool(args.dump_embeddings))
    if mesh is not None and mesh.rank != 0:
        return 0
    if res.metrics:
        print({k: round(v, 6) if isinstance(v, float) else v
               for k, v in res.metrics.items()})
    if args.dump_embeddings:
        dump_embeddings(args.dump_embeddings, model, res)
    return 0


def dump_embeddings(path: str, model, res) -> None:
    """The ``.npz`` of ``--dump_embeddings``; an FMSL head's prototypes and
    class weights normalised as the head uses them (``heads/fmsl.py``)."""
    extras = {}
    fmsl = getattr(model, "fmsl", None)
    for key, name in (("prototypes", "prototypes"), ("weight", "class_weights")):
        v = getattr(fmsl, key, None)
        if v is not None:
            v = v.detach().float().cpu().numpy()
            extras[name] = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
    np.savez(path, utt_ids=np.array(res.utt_ids), features=res.features,
             scores=res.scores, **extras)
    logging.info("dumped %d embeddings (dim %d) to %s",
                 len(res.utt_ids), res.features.shape[-1], path)


if __name__ == "__main__":
    sys.exit(main())
