"""Readings that set a cell's correctness limit, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload maze6.eval.b128 \
        --seeds 11,12,13 --control_seeds 1,2,3 --seconds 1

``--seeds``: sound runs of the program, one ``run.py`` run each (the same
driver, in this one process), printing each compared number. ``--control_seeds``:
the control, the reference computed in the precision below the one the
configuration states (float8 products where it states bfloat16), judged as
the program is: it has to come out not correct. The benchmark's own runs do
not run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))

from benchlib import common  # noqa: E402
from benchlib.common import log  # noqa: E402


def controls(cell, seeds, device):
    """The control's readings on ``seeds``, by the cell's driver."""
    if cell.traffic["driver"] == "train":
        from benchlib import train_driver

        return train_driver.control_readings(cell, seeds, device)
    return control_readings(cell, seeds, device)


def control_readings(cell, seeds, device):
    """The eval control's compared numbers on ``seeds``."""
    import numpy as np

    from benchlib import eval_driver, program, traffic as tgen, weights

    ref = importlib.import_module(f"reference.{cell.config['reference']}")
    _, model = program.build(cell.config, device, eval_kernels=True)
    entries = weights.plan(model, cell.config)
    del model
    out = []
    for seed in seeds:
        x = tgen.audio(cell.traffic, seed, device)
        sd, _ = eval_driver.make_weights(cell, ref, entries, seed, x, device)
        prefix, tmp = tgen.write_pack(cell.traffic, seed, x)
        del x
        with tmp:
            _, rows = eval_driver.sample_checks(seed, 1, cell.traffic["utterances"],
                                                cell.traffic["check_rows"])
            r32 = eval_driver.reference_scores(cell, ref, sd, prefix, rows, device)
            low = eval_driver.reference_scores(cell, ref, sd, prefix, rows, device, "fp8")
        gap = eval_driver.score_gap(low, r32)
        d = np.abs(low - r32)
        out.append({"seed": seed, "score_gap": gap, "rms_gap": float(np.sqrt((d * d).mean())),
                    "ref_std": float(np.std(r32)),
                    "correct": bool(gap <= cell.limits["score_gap"])})
        log("control " + json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=["half_batch"], default=None,
                   help="train cells: plant a fault under the program's runs")
    args = p.parse_args(argv)
    common.set_cache_dirs()
    cell = common.load_cell(args.workload)
    import torch

    common.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        {"eval": "benchlib.eval_driver", "train": "benchlib.train_driver"}[
            cell.traffic["driver"]])
    kw = {}
    if args.fault:
        kw["fault"] = getattr(driver, args.fault)
    for s in filter(None, args.seeds.split(",")):
        r = driver.run(cell, int(s), args.seconds, False, device, **kw)
        torch.cuda.reset_peak_memory_stats()
        print("program " + json.dumps({"seed": int(s), "checks": r.checks,
                                       "correct": r.correct, "metrics": r.metrics}),
              flush=True)
    seeds = [int(s) for s in args.control_seeds.split(",") if s]
    if seeds:
        for r in controls(cell, seeds, device):
            print("control " + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
