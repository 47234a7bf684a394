#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adfmsl_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel library from ``adfmsl_torch/csrc``
   (one ``nvcc`` per library, all started together);
2. kernel K1 (the folded eval SE-ResBlock body) against its plain PyTorch
   version on the card: the CPU tests' four cases, block0 with ``pre`` and
   block4 at batch 8, and the five blocks of maze5 at batch 128 and cut 64600.
   Each line gives the max abs error beside its tolerance (y: 2e-2 * max|y|,
   sums: 1e-3 * max|sums|), the kernel's and the plain version's times, the
   time of a cuDNN composition of the same function (information only: no
   single PyTorch call computes it) and the bound. The comparisons run with
   TF32 off in cuDNN and cuBLAS, so the plain version is exact f32;
3. the main path, for maze5 and then maze5_fmsl: a synthetic ASVspoof fixture
   with 40 eval utterances goes through ``adfmsl_torch.cli.evaluate`` at full
   width, cut 64600 and batch 16 (a ragged last batch); the score file must
   hold one finite score per protocol utterance in protocol order, the EER
   must be printed, and K1 must have launched 5 times per batch. Then the
   folded model's logits are held against the unfolded bf16 trunk (cuDNN
   convs, no K1) on 4 clips, and eval throughput is timed at batch 128 on
   random audio, folded and unfolded;
4. a ``kernels`` line: every ported kernel with its main-path launches, its
   max error, and its per-forward time (the five maze5 blocks at batch 128)
   beside its plain version's time and its bound.

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
# maze5's five trunk blocks at cut 64600: (T, Cin, Cout, pre, 1x1 skip)
MAZE5_BLOCKS = [(64350, 128, 128, False, False), (32175, 128, 128, True, False),
                (16088, 128, 128, True, False), (8044, 128, 128, True, False),
                (4022, 128, 256, True, True)]
K1_CASES = [  # name, B, T, Cin, Cout, pre, skip, act, pool
    ("head", 2, 100, 128, 128, False, False, "relu", 1),
    ("ragged", 2, 300, 128, 128, True, False, "relu", 1),
    ("skip1x1", 1, 77, 128, 256, True, True, "relu", 1),
    ("leaky_pool3", 2, 151, 128, 128, True, False, "leaky", 3),
    ("block0_pre_b8", 8, 64350, 128, 128, True, False, "relu", 1),
    ("block4_b8", 8, 4022, 128, 256, True, True, "relu", 1),
] + [(f"maze5_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip,
     "relu", 1) for i, (t, cin, cout, pre, skip) in enumerate(MAZE5_BLOCKS)]


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


def phase_kernels(rf, dev):
    """K1 against its plain version, TF32 off so the plain version is f32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return [k1_case(rf, *c, seed=i, dev=dev) for i, c in enumerate(K1_CASES)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def phase_main_path(name, rf, fixture, tmp):
    """Drive the evaluate CLI on the card; returns the run's record."""
    from adfmsl_torch.cli import evaluate

    ev = fixture["eval"]
    out = os.path.join(tmp, f"{name}_scores.txt")
    argv = ["--model_type", name, "--protocol", ev["protocol"],
            "--data_dir", ev["audio_dir"], "--output", out,
            "--batch_size", str(EVAL_BATCH), "--cut", str(CUT),
            "--device", "cuda", "--seed", "0"]
    buf = io.StringIO()
    rf.resblock_eval.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rf.resblock_eval.launches
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
    check(launches == 5 * n_batches,
          f"{name}: K1 launched {launches} times, expected {5 * n_batches}")
    rec = {"model": name, "utterances": len(ids), "batch": EVAL_BATCH,
           "batches": n_batches, "k1_launches": launches,
           "eer": metrics[-1]["eer"], "wall_s": wall_s}
    print("main_path " + json.dumps(rec), flush=True)
    return rec


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
        model, reps = models[fused], 5
        with torch.inference_mode():
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = model(x)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(out["scores"]).all()), f"{name}: non-finite scores")
        rec[key] = BENCH_BATCH * reps / secs
        rec[key.replace("utt_per_s", "forward_ms")] = secs / reps * 1e3
    print("throughput " + json.dumps(rec), flush=True)
    del models, x
    torch.cuda.empty_cache()


def kernels_line(k1, main_path):
    """The ``kernels`` record: K1's main-path launches and its errors over all
    cases; its times and bound summed over the five maze5 blocks, i.e. per
    forward at batch 128."""
    blocks = [r for r in k1 if r["case"].startswith("maze5_block")]
    ops_ms = sum(r["ops_ms"] for r in blocks)
    bytes_ms = sum(r["bytes_ms"] for r in blocks)
    return {"kernels": [{
        "id": "K1", "name": "resblock_eval", "route": "cuda",
        "source": "adfmsl_torch/csrc/resblock_eval.cu",
        "replaces": "adfmsl/ops/pallas/resblock_fused.py:141",
        "launches": sum(r["k1_launches"] for r in main_path),
        "launches_by_path": {r["model"]: r["k1_launches"] for r in main_path},
        "max_abs_err": max(r["max_abs_err_y"] for r in k1),
        "max_err_over_tol": max(max(r["max_abs_err_y"] / r["tol_y"],
                                    r["max_abs_err_sums"] / r["tol_sums"]) for r in k1),
        "ms": sum(r["kernel_ms"] for r in blocks),
        "plain_ms": sum(r["plain_ms"] for r in blocks),
        "bound_ms": sum(r["bound_ms"] for r in blocks),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "shapes": f"the five maze5 trunk blocks at batch {BENCH_BATCH}, cut {CUT}",
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

    k1 = phase_kernels(rf, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = generate_fixture(tmp, SyntheticSpec(n_train=0, n_dev=0,
                                                      n_eval=EVAL_UTTS))
        main_path = [phase_main_path(n, rf, fixture, tmp) for n in ("maze5", "maze5_fmsl")]
    for n in ("maze5", "maze5_fmsl"):
        phase_throughput(n, dev, smi)

    print(smi, flush=True)
    print(json.dumps(kernels_line(k1, main_path)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
