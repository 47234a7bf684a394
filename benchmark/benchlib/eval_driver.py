"""Protocol scoring: ``produce_scores`` over a ``DataLoader`` of a pack.

Set-up builds the model through the port's registry with the evaluate CLI's
kernels, loads the seed's weights, writes the seed's pack and scores two
batches of it (every shape of the window). The window scores whole passes of
the pack, closed loop with one caller as ``cli.evaluate --pack`` does, until
``--seconds`` have passed. Afterwards, with the program freed, the reference
scores a sample of (pass, utterance) pairs drawn from the seed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import time

import numpy as np
import torch

from benchlib import program, readers, trace as tr, traffic as tgen, weights
from benchlib.common import Result, log

CHECK_TAG = 0xC4EC


def sample_checks(seed: int, passes: int, n: int, k: int):
    """(pass, row) pairs to judge: ``k`` distinct rows, each in a pass drawn
    from the seed."""
    rng = np.random.default_rng([seed, CHECK_TAG])
    rows = np.sort(rng.choice(n, size=min(k, n), replace=False))
    return rng.integers(0, passes, size=len(rows)), rows


def aligned(res, pos, n: int) -> np.ndarray:
    """A pass's scores by protocol row; a row with no score is NaN (the
    runner's non-finite scores already read -1e9)."""
    out = np.full(n, np.nan)
    rows = [pos.get(u, -1) for u in res.utt_ids]
    keep = [i for i, r in enumerate(rows) if r >= 0]
    out[[rows[i] for i in keep]] = np.asarray(res.scores)[keep]
    return out


def score_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between the program's and the reference's scores, in
    the scores' own unit (a non-finite score reads as infinite)."""
    d = np.abs(prog.astype(np.float64) - ref)
    return float(np.max(np.where(np.isfinite(d), d, math.inf)))


def make_weights(cell, ref, entries, seed, x, device):
    """The seed's weights, their BatchNorm statistics calibrated on the first
    ``calibration_rows`` utterances of ``x``; returns (weights, statistics)."""
    sd = weights.draw(entries, seed, device, cell.config)
    stats = weights.calibrate(sd, ref, cell.config, x[:cell.traffic["calibration_rows"]])
    return sd, stats


def reference_scores(cell, ref, sd, prefix, rows, device, prec="f32"):
    """The reference's scores of ``rows`` of the pack, in blocks, float32
    (``prec`` 'fp8': the control)."""
    from reference import ops

    out = []
    block = cell.traffic.get("check_block", 32)
    with torch.no_grad(), ops.no_tf32():
        for i in range(0, len(rows), block):
            x = torch.from_numpy(tgen.read_rows(prefix, rows[i:i + block])).to(device)
            out.append(ref.scores(sd, x, cell.config, ops.Prec(prec)).double().cpu().numpy())
    return np.concatenate(out)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start=None) -> Result:
    from adfmsl_torch.data import DataLoader, PackedDataset
    from adfmsl_torch.data.protocol import Protocol, ProtocolEntry
    from adfmsl_torch.evaluation import produce_scores

    cfg, trf = cell.config, cell.traffic
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    cuda = device.type == "cuda"
    _, model = program.build(cfg, device, eval_kernels=True)
    entries = weights.plan(model, cfg)
    x_all = tgen.audio(trf, seed, device)
    sd, stats = make_weights(cell, ref, entries, seed, x_all, device)
    model.load_state_dict(sd)
    del sd
    prefix, tmp = tgen.write_pack(trf, seed, x_all)
    del x_all
    with tmp:
        ds = PackedDataset(prefix)
        ids = list(ds.protocol.utt_ids)
        pos = {u: i for i, u in enumerate(ids)}
        n, batch = len(ids), trf["batch"]
        loader = DataLoader(ds, batch, shuffle=False, drop_last=False, prefetch=trf["prefetch"])
        warm_ids = ids[:2 * batch]
        warm = DataLoader(PackedDataset(prefix, Protocol([ProtocolEntry("-", u, "-", None)
                                                          for u in warm_ids])),
                          batch, shuffle=False, drop_last=False, prefetch=trf["prefetch"])
        produce_scores(model, warm)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_start if t_start else None

        timed = program.TimedLoader(loader, traced)
        hooks = tr.stage_hooks(model, readers.stages(cell.per_layer)) if traced else []
        prof = contextlib.nullcontext()
        if traced:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        passes, pass_s = [], []
        failed = 0
        with prof:
            t0 = time.perf_counter()
            while True:
                tp = time.perf_counter()
                with tr.host_range("bench.pass", traced):
                    res = produce_scores(model, timed)
                pass_s.append(time.perf_counter() - tp)
                failed += (n - len(res.utt_ids)) + res.n_nonfinite
                failed += sum(a != b for a, b in zip(res.utt_ids, ids))
                passes.append(aligned(res, pos, n))
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        attempted = n * len(passes)
        log(f"window: {len(passes)} passes of {n} utterances in {window_s:.3f} s; "
            f"median pass {float(np.median(pass_s)):.4f} s; batches "
            f"{len(timed.waits)}")

        metrics, device_info, breakdown = {}, {}, None
        if traced:
            t_red = time.perf_counter()
            trace = tr.collect(prof)
            ctx = readers.Context(cell=cell, ref=ref, trace=trace, window_s=window_s,
                                  rows=attempted, calls=len(timed.waits),
                                  loader_waits_s=timed.waits)
            metrics = readers.read_all(cell.per_layer, ctx)
            breakdown = tr.breakdown(trace)
            device_info = {"busy_s": trace.busy_us() / 1e6, "window_s": window_s}
            log(f"trace: {len(trace.kernels)} device events reduced in "
                f"{time.perf_counter() - t_red:.1f} s")
        else:
            metrics = {"eval_utt_per_s": {"value": attempted / window_s, "unit": "utt/s"}}
            if setup_s is not None:
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}

        scores_by_pass = passes
        del model, loader, warm, timed, ds, prof
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        which, rows = sample_checks(seed, len(scores_by_pass), n, trf["check_rows"])
        prog = np.asarray([scores_by_pass[p][r] for p, r in zip(which, rows)])
        t_ref = time.perf_counter()
        sd = weights.draw(entries, seed, device, cfg)
        sd.update(stats)
        refs = reference_scores(cell, ref, sd, prefix, rows, device)
        gap = score_gap(prog, refs)
        d = np.abs(prog - refs)
        log(f"reference: {len(rows)} utterances in {time.perf_counter() - t_ref:.2f} s; "
            f"rms gap {float(np.sqrt((d * d).mean())):.6g}; reference scores: std "
            f"{float(np.std(refs)):.6g}, mean {float(np.mean(refs)):.6g}")

    limit = cell.limits["score_gap"]
    checks = {"score_gap": {"value": gap, "limit": limit},
              "failed": {"value": failed, "limit": 0}}
    correct = bool(gap <= limit and failed == 0)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **device_info}
    return Result(correct, attempted, failed, metrics, dev, checks, breakdown)
