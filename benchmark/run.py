"""One run of one benchmark cell of adfmsl_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload maze5_fmsl.eval.b128 --seed 7 \
        --seconds 30 --trace 0

Finds ``workloads/<name>.json``, its configuration and traffic, and runs the
traffic's driver (``eval`` or ``train``). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
window. The last line of standard output is the result as one JSON object;
every number that decided ``correct`` is printed beside its limit on the last
lines of standard error. A run exits non-zero and prints no result without
the card(s) the cell needs, or when JAX, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))      # the checkout's root: adfmsl_torch

from benchlib import common  # noqa: E402
from benchlib.common import log  # noqa: E402

DRIVERS = {"eval": "benchlib.eval_driver", "train": "benchlib.train_driver"}


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    t_start = common.process_start_time() or T_IMPORT
    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    import importlib

    import torch

    common.require_cards(cell.chips)
    log(f"card {common.card_info()}; torch {torch.__version__} cuda {torch.version.cuda}")
    driver = importlib.import_module(DRIVERS[cell.traffic["driver"]])
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), t_start)
    found = common.forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    result.emit()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
