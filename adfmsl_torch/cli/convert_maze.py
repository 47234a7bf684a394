"""Convert a reference torch ``.pth`` maze checkpoint into a checkpoint
directory of the port (port of ``adfmsl/cli/convert_maze.py``).

    python -m adfmsl_torch.cli.convert_maze --torch_ckpt M.pth --model_type maze5 \\
        --out OUT [--no_drift] [--cut 64600] [--device cuda|cpu]

The reference's eval scripts rebuild the torch model and
``load_state_dict(strict=False)`` (Maze5_eval.py:321, comprehensive_evaluation.py:
411-435); this is the port's analog. The weights are mapped by
``models/port.py:port_maze_state_dict`` (all 16 maze models), laid over a
freshly built model of ``reference_parity_experiment`` (the 'reference' sinc
formula and block semantics, f32), written as epoch 0 of ``OUT``
(``train/checkpoint.py``, metrics ``{"dev_acc": 0.0}``) with its
``OUT/experiment.yaml``. So ``python -m adfmsl_torch.cli.evaluate --model_path
OUT`` scores with it, and ``python -m adfmsl_torch.cli.train --config
OUT/experiment.yaml --checkpoint_dir OUT --restore`` fine-tunes it. Missing and
unconsumed torch keys are logged; a missing one keeps its random init. The
checkpoint is unpickled (``load_torch_state_dict``): convert trusted files
only. Builds on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def build_parser():
    p = argparse.ArgumentParser("adfmsl_torch.cli.convert_maze")
    p.add_argument("--torch_ckpt", required=True, help=".pth / .pt state dict")
    p.add_argument("--model_type", required=True,
                   help="registry name: all 16 reference models (main, maze2..8 and "
                        "their _fmsl variants; maze2_fmsl ports under fixed head "
                        "semantics, models/port.py)")
    p.add_argument("--out", required=True, help="output checkpoint directory")
    p.add_argument("--no_drift", action="store_true")
    p.add_argument("--cut", type=int, default=64600,
                   help="clip length stored in the emitted experiment.yaml")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from adfmsl_torch.config import save_yaml
    from adfmsl_torch.models import (build_model, load_torch_state_dict, merge,
                                     port_maze_state_dict, reference_parity_experiment,
                                     state_dict_from_flax)
    from adfmsl_torch.train import CheckpointManager, Optimizer, TrainState

    exp = reference_parity_experiment(args.model_type, drift=not args.no_drift)
    exp.data.cut = args.cut
    sd = load_torch_state_dict(args.torch_ckpt)
    params, stats, report = port_maze_state_dict(sd, args.model_type)
    if report.get("gru_layers"):
        exp.model.architecture.nb_gru_layer = report["gru_layers"]
    if report["missing"]:
        logging.warning("missing torch keys (kept init values): %s", report["missing"])
    if report["unconsumed"]:
        logging.warning("unconsumed torch keys: %s", report["unconsumed"])

    model = build_model(exp.model, device=args.device, seed=0)
    ported = state_dict_from_flax(params, stats, args.model_type)
    model.load_state_dict(merge(model.state_dict(), ported), strict=True)
    opt = Optimizer.for_model(exp, model, steps_per_epoch=1)
    CheckpointManager(args.out).save(0, exp, TrainState(model, opt, exp.train.seed),
                                     {"dev_acc": 0.0})
    save_yaml(exp, os.path.join(os.path.abspath(args.out), "experiment.yaml"))
    print(f"ported {args.torch_ckpt} ({args.model_type}) -> {args.out} "
          f"[missing={len(report['missing'])} unconsumed={len(report['unconsumed'])}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
