"""Training: ``Trainer.train_epoch`` over a shuffled ``DataLoader`` of a pack.

Set-up builds the port's ``Trainer`` (model, AdamW, the train step with its
non-finite guard) for the configuration at the traffic's batch, loads the
seed's weights, and drives it through the first ``check_steps`` steps of
epoch 0 by ``train_epoch`` itself: those steps are the warm-up and the ones
the reference follows. The window goes on with the same object, epoch after
epoch, until ``--seconds`` have passed (the loader's iterator then ends the
epoch). No dev evaluation and no checkpoint run in it.

A step's time runs from the Trainer's request for its batch to its request
for the next, so it holds the loader's wait, the step's dispatch and the
guard's host sync. ``train_utt_per_s`` is every row of every step over the
window's seconds; ``train_step_ms_p90`` the 90th percentile of every step.

Correctness: the reference repeats the first steps in float32 from the same
weights, rows and random draws (the step streams are drawn as the port
documents them, ``train/state.py``: a generator a stream on the card, seeded
from (seed, epoch, step, tag) through numpy's ``SeedSequence``), and compares
each step's loss, the first step's gradient as the optimizer got it (from
AdamW's first moment after one step) and the parameters' change after the
last, leaf by leaf.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time

import numpy as np
import torch

from benchlib import program, readers, trace as tr, traffic as tgen, weights
from benchlib.common import Result, log

STREAM_TAGS = {"dropout": 1, "specaugment": 2}


def step_generators(seed: int, epoch: int, index: int, device):
    out = {}
    for name, tag in STREAM_TAGS.items():
        words = np.random.SeedSequence([seed, epoch, index, tag]).generate_state(2)
        g = torch.Generator(device=device)
        g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
        out[name] = g
    return out


def epoch_rows(n: int, batch: int, seed: int, epoch: int, steps: int):
    """The rows of the first ``steps`` batches of a shuffled epoch."""
    ids = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(ids)
    return [ids[i * batch:(i + 1) * batch] for i in range(steps)]


def window_metrics(step_s, rows: int, window_s: float) -> dict:
    """The end-to-end numbers of a window: every row over every second, and
    the 90th percentile of every step's time."""
    return {"train_utt_per_s": {"value": rows / window_s, "unit": "utt/s"},
            "train_step_ms_p90": {"value": 1e3 * float(np.percentile(step_s, 90)),
                                  "unit": "ms"}}


def leaf_gap(prog, ref, keep=None) -> float:
    """The worst leaf's gap between the program's and the reference's norm,
    over the larger of that leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def worst_leaf(prog, ref) -> str:
    med = float(np.median(list(ref.values())))
    return max(ref, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med))


def reference_steps(cell, ref, sd0, params, x_rows, y_rows, seed, device, prec="f32"):
    """The reference's first steps: (losses, the first clipped gradient's
    leaf norms, the leaves after the last step)."""
    from reference import ops

    cfg, t = cell.config, cell.config["train"]
    b1, b2 = t["betas"]
    lr, wd, eps, clip = t["lr"], t["weight_decay"], t["eps"], t["grad_clip_norm"]
    p = {k: sd0[k].clone().requires_grad_(True) for k in params}
    bufs = {k: v for k, v in sd0.items() if k not in params}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    with ops.no_tf32():
        for step, (x, y) in enumerate(zip(x_rows, y_rows)):
            gens = step_generators(seed, 0, step, device)
            logits = ref.train_logits({**bufs, **p}, x, cfg, ops.Prec(prec), gens)
            loss = ref.loss(logits, y, cfg)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = {k: (torch.zeros_like(p[k]) if gi is None
                         else torch.nan_to_num(gi, nan=0.0, posinf=0.0, neginf=0.0))
                     for k, gi in zip(p, grads)}
                norm = torch.sqrt(sum((gi * gi).sum() for gi in g.values()))
                factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
                n = step + 1
                for k in p:
                    gk = g[k] * factor
                    if first is None:
                        g[k] = gk
                    p[k].mul_(1 - lr * wd)
                    m[k].lerp_(gk, 1 - b1)
                    v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                    denom = (v[k].sqrt() / (1 - b2 ** n) ** 0.5).add_(eps)
                    p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** n))
                if first is None:
                    first = {k: float(g[k].norm()) for k in p}
    return losses, first, {k: t_.detach() for k, t_ in p.items()}


def compare(cell, prog_losses, prog_first, prog_after, ref_losses, ref_first, ref_after, sd0):
    """The numbers read against the reference: the first step's relative loss
    gap, the later steps' worst one, and the worst leaf's gap of the first
    gradient's norm and of the change's norm (leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change: they move by weight decay and round-off only)."""
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog_losses, ref_losses)]
    med = float(np.median(list(ref_first.values())))
    moving = {k for k, g in ref_first.items() if g >= 1e-3 * med}
    dp = {k: float((prog_after[k] - sd0[k]).norm()) for k in ref_after}
    dr = {k: float((ref_after[k] - sd0[k]).norm()) for k in ref_after}
    return {"loss_gap_first": gaps[0], "loss_gap_later": max(gaps[1:], default=0.0),
            "grad_gap": leaf_gap(prog_first, ref_first),
            "change_gap": leaf_gap(dp, dr, moving)}


def half_batch(audio, labels, mask):
    """A fault: the loss over the first half of the rows only."""
    keep = torch.arange(len(mask), device=mask.device) < len(mask) // 2
    return audio, labels, mask & keep


def control_readings(cell, seeds, device):
    """The control's compared numbers: the reference with float8 products in
    the program's place, against the float32 reference, on each seed."""
    ref = importlib.import_module(f"reference.{cell.config['reference']}")
    trf, out = cell.traffic, []
    _, model = program.build(cell.config, torch.device("cpu"), eval_kernels=False)
    entries = weights.plan(model, cell.config)
    names = [nm for nm, _ in model.named_parameters()]
    del model
    for seed in seeds:
        x = tgen.audio(trf, seed, device)
        y = torch.from_numpy(tgen.labels(trf, seed)).long().to(device)
        rows = [torch.from_numpy(r).to(device)
                for r in epoch_rows(trf["utterances"], trf["batch"], seed, 0, trf["check_steps"])]
        xs, ys = [x[r] for r in rows], [y[r] for r in rows]
        sd0 = weights.draw(entries, seed, device, cell.config)
        r32 = reference_steps(cell, ref, sd0, names, xs, ys, seed, device)
        low = reference_steps(cell, ref, sd0, names, xs, ys, seed, device, "fp8")
        nums = compare(cell, low[0], low[1], low[2], *r32, sd0)
        out.append({"seed": seed, **nums,
                    "correct": all(nums[k] <= v for k, v in cell.limits.items())})
    return out


def build_trainer(cell, seed, device, loader):
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.train.loop import Trainer

    cfg, trf = cell.config, cell.traffic
    exp = make_experiment(cfg["program"]["model_type"])
    for path, value in cfg["program"].get("overrides", {}).items():
        program.set_path(exp, path, value)
    exp.train.batch_size = trf["batch"]
    exp.train.seed = seed
    return Trainer(exp, loader, device=device, persist_config=False)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start=None,
        fault=None) -> Result:
    from adfmsl_torch.data import DataLoader, PackedDataset

    cfg, trf = cell.config, cell.traffic
    seed = seed % 2 ** 32                    # numpy's global seed, which the Trainer sets
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    cuda = device.type == "cuda"
    n, batch, k = trf["utterances"], trf["batch"], trf["check_steps"]
    x_all = tgen.audio(trf, seed, device)
    prefix, tmp = tgen.write_pack(trf, seed, x_all)
    del x_all
    with tmp:
        ds = PackedDataset(prefix)
        loader = DataLoader(ds, batch, shuffle=True, drop_last=True, seed=seed,
                            prefetch=trf["prefetch"])
        timed = program.TimedLoader(loader, traced)
        trainer = build_trainer(cell, seed, device, timed)
        model, opt = trainer.state.model, trainer.state.optimizer
        entries = weights.plan(model, cfg)
        model.load_state_dict(weights.draw(entries, seed, device, cfg))
        names = [nm for nm, _ in model.named_parameters()]
        beta1 = opt.opt.param_groups[0]["betas"][0]
        rec, first = [], {}
        step = trainer.train_step

        def recorded(state, audio, labels, mask, rngs):
            if fault is not None:
                audio, labels, mask = fault(audio, labels, mask)
            m = step(state, audio, labels, mask, rngs)
            rec.append((m["loss"], m["skipped"]))
            if len(rec) == 1:
                first.update({nm: torch.linalg.vector_norm(
                    opt.opt.state.get(p, {}).get("exp_avg", torch.zeros(()))) / (1 - beta1)
                    for nm, p in zip(names, opt.params)})
            return m
        trainer.train_step = recorded

        timed.keep_ids, timed.limit = True, k
        trainer.train_epoch(0)
        after = {nm: p.detach().clone() for nm, p in zip(names, opt.params)}
        seen_ids = timed.batches[:k]
        timed.keep_ids, timed.limit = False, None
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_start if t_start else None

        prof = contextlib.nullcontext()
        if traced:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        in_s0 = trainer.timer.totals.get("input", 0.0)
        first_epoch = len(timed.requests)
        with prof:
            t0 = time.perf_counter()
            timed.stop_at = t0 + seconds
            epoch = 1
            while time.perf_counter() < timed.stop_at:
                trainer.train_epoch(epoch)
                epoch += 1
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        steps = len(rec) - k
        step_s = [b - a for reqs in timed.requests[first_epoch:] for a, b in zip(reqs, reqs[1:])]
        skipped = int(sum(float(s) for _, s in rec[k:])) if steps else 0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        log(f"window: {steps} steps of {batch} in {window_s:.3f} s over {epoch - 1} epochs; "
            f"{len(step_s)} step times, median {1e3 * float(np.median(step_s)):.2f} ms")

        metrics, device_info, breakdown = {}, {}, None
        if traced:
            trace = tr.collect(prof)
            ctx = readers.Context(
                cell=cell, ref=ref, trace=trace, window_s=window_s, rows=steps * batch,
                calls=steps,
                timer={"input_s": trainer.timer.totals.get("input", 0.0) - in_s0})
            metrics = readers.read_all(cell.per_layer, ctx)
            breakdown = tr.breakdown(trace)
            device_info = {"busy_s": trace.busy_us() / 1e6, "window_s": window_s}
        else:
            metrics = window_metrics(step_s, steps * batch, window_s)
            if setup_s is not None:
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}

        prog_losses = [float(l_) for l_, _ in rec[:k]]
        prog_first = {nm: float(v) for nm, v in first.items()}
        del trainer, model, opt, step, loader, timed, prof, rec, first
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        rows = epoch_rows(n, batch, seed, 0, k)
        ids = tgen.utt_ids(n)
        id_match = len(seen_ids) == k and all([ids[r] for r in rw] == s
                                              for rw, s in zip(rows, seen_ids))
        y_all = tgen.labels(trf, seed)
        xs = [torch.from_numpy(tgen.read_rows(prefix, rw)).to(device) for rw in rows]
        ys = [torch.from_numpy(y_all[rw]).long().to(device) for rw in rows]
        sd0 = weights.draw(entries, seed, device, cfg)
        t_ref = time.perf_counter()
        ref_losses, ref_first, ref_after = reference_steps(cell, ref, sd0, names, xs, ys, seed,
                                                           device)
        nums = compare(cell, prog_losses, prog_first, after, ref_losses, ref_first, ref_after,
                       sd0)
        log(f"reference: {k} steps in {time.perf_counter() - t_ref:.2f} s; losses program "
            f"{prog_losses} reference {ref_losses}; the first gradient's worst leaf "
            f"{worst_leaf(prog_first, ref_first)}; not compared: loss_gap_later "
            f"{nums['loss_gap_later']!r}")

    checks = {name: {"value": nums[name], "limit": cell.limits[name]} for name in cell.limits}
    checks["rows"] = {"value": 0 if id_match else 1, "limit": 0}
    checks["skipped"] = {"value": skipped, "limit": 0}
    correct = bool(all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **device_info}
    return Result(correct, steps, skipped, metrics, dev, checks, breakdown)
