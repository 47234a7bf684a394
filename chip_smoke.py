#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adfmsl_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel library from ``adfmsl_torch/csrc``
   (one ``nvcc`` per library, all started together);
2. kernel K1 (the folded eval residual-block body) against its plain PyTorch
   version on the card: the CPU tests' cases, block0 with ``pre`` and block4
   at batch 8, the five blocks of maze5 and the six RawNet blocks of main
   (LeakyReLU, MaxPool3) at batch 128 and cut 64600. Each line gives the max
   abs error beside its tolerance (y: 2e-2 * max|y|, sums: 1e-3 * max|sums|),
   the kernel's and the plain version's times, the time of a cuDNN
   composition of the same function (information only: no single PyTorch
   call computes it) and the bound;
3. kernel K3 (the fused sinc conv + |.| + MaxPool3 RawNet front end) against
   its plain version: the CPU tests' (2, 8000) and ragged cases, and batch 16
   and 128 at cut 64600, C 128, K 251. Error against 1e-3 * max|plain|; the
   kernel's, the plain version's and a bf16 cuDNN composition's times (conv1d
   -> abs -> max_pool1d, information only) beside the bound. Phases 2 and 3
   run with TF32 off in cuDNN and cuBLAS, so the plain versions are exact f32;
4. the main path, for maze5, maze5_fmsl, main and main_fmsl: a synthetic
   ASVspoof fixture with 40 eval utterances goes through
   ``adfmsl_torch.cli.evaluate`` at full width, cut 64600 and batch 16 (a
   ragged last batch; RawNet with ``--fused_frontend``); the score file must
   hold one finite score per protocol utterance in protocol order, the EER
   must be printed, and the kernels must have launched as the path says: K1
   5 times per batch for maze5 and 6 for RawNet, K3 once per RawNet batch.
   Every count is set to 0 just before a path and read just after it;
5. throughput: maze5 and maze5_fmsl folded vs unfolded trunk at batch 128
   (logits held against each other on 4 clips first); main at batch 16 with
   the K3 front end and with the composition (logits held against each other
   first), and at batch 128 (composition front end, K1 trunk);
6. a ``kernels`` line: every ported kernel with its launches on the main
   paths, its max error, its time at the main path's shapes beside its plain
   version's time, its bound and the library call's time (none exists).

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
before it. Without a card, or without the repo beside this script, the run
exits non-zero and prints no result.
"""
from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12          # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12              # H100 SXM data sheet, HBM3
CUT = 64600
EVAL_UTTS, EVAL_BATCH = 40, 16
BENCH_BATCH = 128
SINC_C, SINC_K = 128, 251
# maze5's five trunk blocks at cut 64600: (T, Cin, Cout, pre, 1x1 skip)
MAZE5_BLOCKS = [(64350, 128, 128, False, False), (32175, 128, 128, True, False),
                (16088, 128, 128, True, False), (8044, 128, 128, True, False),
                (4022, 128, 256, True, True)]
# RawNet main's six blocks (LeakyReLU, MaxPool3) at cut 64600: T = 21450 after
# the front end, a third after each block
MAIN_BLOCKS = [(21450, 128, 128, False, False), (7150, 128, 128, True, False),
               (2383, 128, 256, True, True), (794, 256, 256, True, False),
               (264, 256, 256, True, False), (88, 256, 256, True, False)]
K1_CASES = [  # name, B, T, Cin, Cout, pre, skip, act, pool
    ("head", 2, 100, 128, 128, False, False, "relu", 1),
    ("ragged", 2, 300, 128, 128, True, False, "relu", 1),
    ("skip1x1", 1, 77, 128, 256, True, True, "relu", 1),
    ("leaky_pool3", 2, 151, 128, 128, True, False, "leaky", 3),
    ("rawnet_256_pre", 2, 151, 256, 256, True, False, "leaky", 3),
    ("block0_pre_b8", 8, 64350, 128, 128, True, False, "relu", 1),
    ("block4_b8", 8, 4022, 128, 256, True, True, "relu", 1),
] + [(f"maze5_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip,
     "relu", 1) for i, (t, cin, cout, pre, skip) in enumerate(MAZE5_BLOCKS)
] + [(f"main_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip,
     "leaky", 3) for i, (t, cin, cout, pre, skip) in enumerate(MAIN_BLOCKS)]
K3_CASES = [  # name, B, T
    ("jax_case", 2, 8000), ("ragged", 3, 8001),
    (f"b{EVAL_BATCH}_cut{CUT}", EVAL_BATCH, CUT),
    (f"b{BENCH_BATCH}_cut{CUT}", BENCH_BATCH, CUT)]
# (model, extra CLI flags, K1 launches per batch, K3 launches per batch)
MAIN_PATHS = [("maze5", [], 5, 0), ("maze5_fmsl", [], 5, 0),
              ("main", ["--fused_frontend"], 6, 1),
              ("main_fmsl", ["--fused_frontend"], 6, 1)]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warm`` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k1_bound(b, t, cin, cout, pre, skip, pool):
    """(ops_ms, bytes_ms): K1's conv products at the bf16 tensor-core peak,
    and x read once, y and the sums written once and the operands read once
    at the HBM rate. The bound is the larger of the two."""
    per_row = 3 * cin * cout + 3 * cout * cout + (cin * cout if skip else 0)
    flops = 2.0 * b * t * per_row
    nbytes = (2 * b * t * cin + 2 * b * (t // pool) * cout + 4 * b * cout
              + 2 * per_row + 4 * 2 * cout + (4 * 2 * cin if pre else 0))
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def random_block(g, dev, cin, cout, pre, skip):
    """Folded operands at the CPU tests' scales."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    p = None
    if pre:
        p = randn(2, cin, scale=0.1) + torch.tensor([[1.0], [0.0]], device=dev)
    return (p, randn(3, cin, cout, scale=0.05), randn(cout, scale=0.1),
            randn(3, cout, cout, scale=0.05), randn(cout, scale=0.1),
            randn(cin, cout, scale=0.1) if skip else None)


def cudnn_composition(ops, act):
    """The same function as bf16 cuDNN convs plus elementwise ops: timed beside
    K1 for information only; the port never calls it."""
    pre, w1, b1, w2, bt, skw = ops
    bf = torch.bfloat16
    w1k = w1.to(bf).permute(2, 1, 0).contiguous()
    w2k = w2.to(bf).permute(2, 1, 0).contiguous()
    b1b, btb = b1.to(bf), bt.to(bf)
    skk = None if skw is None else skw.to(bf).T.contiguous()[:, :, None]

    def act_fn(v):
        return torch.relu(v) if act == "relu" else F.leaky_relu(v, 0.3)

    def run(x, pool):
        h = x
        if pre is not None:
            h = act_fn(x.float() * pre[0] + pre[1]).to(bf)
        xt = x.transpose(1, 2)
        y1 = act_fn(F.conv1d(h.transpose(1, 2), w1k, b1b, padding=1))
        out = F.conv1d(y1, w2k, btb, padding=1).float()
        out = out + (xt.float() if skk is None else F.conv1d(xt, skk).float())
        if pool == 3:
            out = F.max_pool1d(out, 3)
        return out.transpose(1, 2).to(bf), out.sum(dim=2)
    return run


def k1_case(rf, name, b, t, cin, cout, pre, skip, act, pool, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, cin), generator=g, device=dev).to(torch.bfloat16)
    ops = random_block(g, dev, cin, cout, pre, skip)
    y, s = rf.resblock_eval(x, *ops, act=act, pool=pool)
    torch.cuda.synchronize()
    yp, sp = rf.resblock_eval_plain(x, *ops, act=act, pool=pool)
    plain_ms = cuda_ms(lambda: rf.resblock_eval_plain(x, *ops, act=act, pool=pool))
    check(tuple(y.shape) == tuple(yp.shape) and tuple(s.shape) == tuple(sp.shape),
          f"K1 {name}: shapes {tuple(y.shape)} {tuple(s.shape)}")
    err_y = (y.float() - yp.float()).abs().max().item()
    err_s = (s - sp).abs().max().item()
    tol_y = 2e-2 * yp.float().abs().max().item()
    tol_s = 1e-3 * sp.abs().max().item()
    del yp, sp, y, s
    ms = cuda_ms(lambda: rf.resblock_eval(x, *ops, act=act, pool=pool))
    comp = cudnn_composition(ops, act)
    composition_ms = cuda_ms(lambda: comp(x, pool))
    ops_ms, bytes_ms = k1_bound(b, t, cin, cout, pre, skip, pool)
    rec = {"case": name, "B": b, "T": t, "cin": cin, "cout": cout, "pre": pre,
           "skip1x1": skip, "act": act, "pool": pool,
           "max_abs_err_y": err_y, "tol_y": tol_y,
           "max_abs_err_sums": err_s, "tol_sums": tol_s,
           "kernel_ms": ms, "plain_ms": plain_ms,
           "cudnn_composition_ms": composition_ms,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print("K1 " + json.dumps(rec), flush=True)
    check(math.isfinite(err_y) and err_y <= tol_y, f"K1 {name}: y error {err_y} > {tol_y}")
    check(math.isfinite(err_s) and err_s <= tol_s,
          f"K1 {name}: sums error {err_s} > {tol_s}")
    del x, ops, comp
    torch.cuda.empty_cache()
    return rec


def k3_bound(b, t, c, k):
    """(ops_ms, bytes_ms): the correlation's 2*B*T'*C*K products at the bf16
    tensor-core peak, and x and the filters read once and the pooled f32
    output written once at the HBM rate. The bound is the larger of the two."""
    t_out = t - k + 1
    flops = 2.0 * b * t_out * c * k
    nbytes = 4 * b * t + 4 * c * k + 4 * b * (t_out // 3) * c
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def k3_case(sf, filters, name, b, t, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.1 * torch.randn((b, t), generator=g, device=dev)
    out = sf.sinc_abs_pool_fused(x, filters)
    torch.cuda.synchronize()
    want = sf.sinc_abs_pool_plain(x, filters)
    check(tuple(out.shape) == tuple(want.shape), f"K3 {name}: shape {tuple(out.shape)}")
    err = (out - want).abs().max().item()
    tol = 1e-3 * want.abs().max().item()
    del out, want
    plain_ms = cuda_ms(lambda: sf.sinc_abs_pool_plain(x, filters))
    ms = cuda_ms(lambda: sf.sinc_abs_pool_fused(x, filters))
    xb, fb = x.to(torch.bfloat16)[:, None, :], filters.to(torch.bfloat16)[:, None, :]
    composition_ms = cuda_ms(lambda: F.max_pool1d(F.conv1d(xb, fb).abs(), 3))
    ops_ms, bytes_ms = k3_bound(b, t, *filters.shape)
    rec = {"case": name, "B": b, "T": t, "C": filters.shape[0], "K": filters.shape[1],
           "max_abs_err": err, "tol": tol, "kernel_ms": ms, "plain_ms": plain_ms,
           "cudnn_bf16_composition_ms": composition_ms,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print("K3 " + json.dumps(rec), flush=True)
    check(math.isfinite(err) and err <= tol, f"K3 {name}: error {err} > {tol}")
    del x, xb, fb
    torch.cuda.empty_cache()
    return rec


def sinc_filters_at_init(dev):
    """The (C, K) filters of a freshly initialised RawNet front end."""
    from adfmsl_torch.ops.sinc import sinc_filters, sinc_init

    low, band = sinc_init(SINC_C)
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), SINC_K).to(dev)


def phase_kernels(rf, sf, dev):
    """K1 and K3 against their plain versions, TF32 off so those are f32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            k1 = [k1_case(rf, *c, seed=i, dev=dev) for i, c in enumerate(K1_CASES)]
            filters = sinc_filters_at_init(dev)
            k3 = [k3_case(sf, filters, *c, seed=i, dev=dev)
                  for i, c in enumerate(K3_CASES)]
            return k1, k3
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def phase_main_path(name, flags, k1_per_batch, k3_per_batch, rf, sf, fixture, tmp):
    """Drive the evaluate CLI on the card; returns the run's record."""
    from adfmsl_torch.cli import evaluate

    ev = fixture["eval"]
    out = os.path.join(tmp, f"{name}_scores.txt")
    argv = ["--model_type", name, "--protocol", ev["protocol"],
            "--data_dir", ev["audio_dir"], "--output", out,
            "--batch_size", str(EVAL_BATCH), "--cut", str(CUT),
            "--device", "cuda", "--seed", "0", *flags]
    buf = io.StringIO()
    rf.resblock_eval.launches = 0
    sf.sinc_abs_pool_fused.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_launches = rf.resblock_eval.launches
    k3_launches = sf.sinc_abs_pool_fused.launches
    text = buf.getvalue()
    check(rc == 0, f"{name}: evaluate exited {rc}")
    metrics = [ast.literal_eval(ln) for ln in text.splitlines() if ln.startswith("{")]
    check(bool(metrics) and "eer" in metrics[-1], f"{name}: no EER printed: {text!r}")
    with open(out) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()]
    ids = [ln[0] for ln in lines]
    scores = np.asarray([float(ln[1]) for ln in lines])
    check(ids == ev["utt_ids"], f"{name}: score file ids differ from the protocol")
    check(bool(np.isfinite(scores).all()), f"{name}: non-finite scores")
    n_batches = -(-EVAL_UTTS // EVAL_BATCH)
    check(k1_launches == k1_per_batch * n_batches,
          f"{name}: K1 launched {k1_launches} times, expected {k1_per_batch * n_batches}")
    check(k3_launches == k3_per_batch * n_batches,
          f"{name}: K3 launched {k3_launches} times, expected {k3_per_batch * n_batches}")
    rec = {"model": name, "flags": flags, "utterances": len(ids), "batch": EVAL_BATCH,
           "batches": n_batches, "k1_launches": k1_launches,
           "k3_launches": k3_launches, "eer": metrics[-1]["eer"], "wall_s": wall_s}
    print("main_path " + json.dumps(rec), flush=True)
    return rec


def forward_rate(model, x, reps: int = 5) -> tuple:
    """(utt/s, ms per forward) over ``reps`` forwards after 2 warm ones, by
    the host clock around work that ends in a synchronize."""
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = model(x)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(out["scores"]).all()), "non-finite scores")
    return x.shape[0] * reps / secs, secs / reps * 1e3


def phase_throughput_main(dev, card):
    """RawNet main: at batch 16 the K3 front end against the composition
    (logits held against each other first), and at batch 128 (composition
    front end, as adfmsl's dispatch picks there) with the K1 trunk."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    models = {}
    for frontend in (True, False):
        exp = make_experiment("main")
        exp.model.extra.update(fused_eval_trunk=True, fused_eval_frontend=frontend)
        models[frontend] = build_model(exp.model, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(2)
    x = 0.1 * torch.randn((BENCH_BATCH, CUT), generator=g, device=dev)
    xs = x[:EVAL_BATCH].contiguous()
    with torch.inference_mode():
        lk = models[True](xs)["logits"].float()
        lc = models[False](xs)["logits"].float()
    err = (lk - lc).abs().max().item()
    tol = 3e-2 * max(1.0, lc.abs().max().item())
    rec = {"model": "main", "card": card, "cut": CUT,
           f"logits_k3_vs_composition_b{EVAL_BATCH}_max_abs_err": err, "tol": tol}
    check(math.isfinite(err) and err <= tol,
          f"main: K3 logits differ from the composition's by {err} > {tol}")
    for frontend, key in ((True, "k3"), (False, "composition")):
        rate, ms = forward_rate(models[frontend], xs)
        rec[f"utt_per_s_b{EVAL_BATCH}_{key}"] = rate
        rec[f"forward_ms_b{EVAL_BATCH}_{key}"] = ms
    rate, ms = forward_rate(models[False], x)
    rec[f"utt_per_s_b{BENCH_BATCH}"] = rate
    rec[f"forward_ms_b{BENCH_BATCH}"] = ms
    print("throughput " + json.dumps(rec), flush=True)
    del models, x, xs
    torch.cuda.empty_cache()


def phase_throughput(name, dev, card):
    """Folded (K1) vs unfolded bf16 trunk: logits agreement on 4 clips, then
    eval utt/s at batch 128 on random audio."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    models = {}
    for fused in (True, False):
        exp = make_experiment(name)
        exp.model.extra["fused_eval_trunk"] = fused
        models[fused] = build_model(exp.model, device=dev, seed=0)
    models[False].load_state_dict(models[True].state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    x = 0.1 * torch.randn((BENCH_BATCH, CUT), generator=g, device=dev)
    with torch.inference_mode():
        lf = models[True](x[:4])["logits"].float()
        lu = models[False](x[:4])["logits"].float()
    err = (lf - lu).abs().max().item()
    tol = 3e-2 * max(1.0, lu.abs().max().item())
    rec = {"model": name, "card": card, "batch": BENCH_BATCH, "cut": CUT,
           "logits_folded_vs_unfolded_max_abs_err": err, "tol": tol}
    check(math.isfinite(err) and err <= tol,
          f"{name}: folded logits differ from the unfolded trunk by {err} > {tol}")
    for fused, key in ((True, "utt_per_s_k1"), (False, "utt_per_s_unfolded")):
        rec[key], rec[key.replace("utt_per_s", "forward_ms")] = forward_rate(models[fused], x)
    print("throughput " + json.dumps(rec), flush=True)
    del models, x
    torch.cuda.empty_cache()


def _summed(recs):
    """Kernel, plain and bound times summed over ``recs`` (one forward's calls)."""
    ops_ms = sum(r["ops_ms"] for r in recs)
    bytes_ms = sum(r["bytes_ms"] for r in recs)
    return {"ms": sum(r["kernel_ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def kernels_line(k1, k3, main_path):
    """The ``kernels`` record. K1: main-path launches and errors over all
    cases; times and bound summed over the five maze5 blocks, i.e. per maze5
    forward at batch 128 (the six RawNet blocks beside them). K3: its times at
    batch 16, the largest batch its dispatch gives it on the main path (batch
    128 beside them)."""
    k3_main = next(r for r in k3 if r["B"] == EVAL_BATCH and r["T"] == CUT)
    k3_big = next(r for r in k3 if r["B"] == BENCH_BATCH)
    return {"kernels": [{
        "id": "K1", "name": "resblock_eval", "route": "cuda",
        "source": "adfmsl_torch/csrc/resblock_eval.cu",
        "replaces": "adfmsl/ops/pallas/resblock_fused.py:141",
        "launches": sum(r["k1_launches"] for r in main_path),
        "launches_by_path": {r["model"]: r["k1_launches"] for r in main_path},
        "max_abs_err": max(r["max_abs_err_y"] for r in k1),
        "max_err_over_tol": max(max(r["max_abs_err_y"] / r["tol_y"],
                                    r["max_abs_err_sums"] / r["tol_sums"]) for r in k1),
        **_summed([r for r in k1 if r["case"].startswith("maze5_block")]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the folded block",
        "shapes": f"the five maze5 trunk blocks at batch {BENCH_BATCH}, cut {CUT}",
        "main_blocks": _summed([r for r in k1 if r["case"].startswith("main_block")]),
    }, {
        "id": "K3", "name": "sinc_abs_pool_fused", "route": "cuda",
        "source": "adfmsl_torch/csrc/sinc_abs_pool.cu",
        "replaces": "adfmsl/ops/pallas/sinc_fused.py:81",
        "launches": sum(r["k3_launches"] for r in main_path),
        "launches_by_path": {r["model"]: r["k3_launches"] for r in main_path},
        "max_abs_err": max(r["max_abs_err"] for r in k3),
        "max_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in k3),
        **_summed([k3_main]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes max_pool3(|conv|); the bf16 "
                        "cuDNN composition is in composition_ms, for information",
        "composition_ms": k3_main["cudnn_bf16_composition_ms"],
        "shapes": f"batch {EVAL_BATCH}, cut {CUT}, C {SINC_C}, K {SINC_K}",
        f"b{BENCH_BATCH}": {**_summed([k3_big]),
                            "composition_ms": k3_big["cudnn_bf16_composition_ms"]},
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import adfmsl_torch

    check(Path(adfmsl_torch.__file__).resolve().parent == ROOT / "adfmsl_torch",
          f"adfmsl_torch imported from {adfmsl_torch.__file__}, not beside this script")
    from adfmsl_torch.data import SyntheticSpec, generate_fixture
    from adfmsl_torch.ops import _build
    from adfmsl_torch.ops import resblock_fused as rf
    from adfmsl_torch.ops import sinc_fused as sf

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    device = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "libraries": sorted(libs)}
    print("device " + json.dumps(device), flush=True)

    k1, k3 = phase_kernels(rf, sf, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = generate_fixture(tmp, SyntheticSpec(n_train=0, n_dev=0,
                                                      n_eval=EVAL_UTTS))
        main_path = [phase_main_path(*p, rf, sf, fixture, tmp) for p in MAIN_PATHS]
    for n in ("maze5", "maze5_fmsl"):
        phase_throughput(n, dev, smi)
    phase_throughput_main(dev, smi)

    print(smi, flush=True)
    print(json.dumps(kernels_line(k1, k3, main_path)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
