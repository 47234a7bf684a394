#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adfmsl_torch``) on one CUDA card.

    python3 chip_smoke.py                   # every phase below
    python3 chip_smoke.py --only kernels    # phases 1 and 2-3d only
    python3 chip_smoke.py --only k2         # K2's library and cases only

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
   call computes it) and the bound, and the kernel's figures for the
   instantiation: tile rows, shared memory a CTA, registers a thread, spills
   and whether ptxas serialised the wgmma products (from the ``-Xptxas -v``
   report in the library's build.log), CTAs an SM (the occupancy calculator)
   and L2 weight bytes per output row;
3. kernel K3 (the fused sinc conv + |.| + MaxPool3 RawNet front end) against
   its plain version: the CPU tests' (2, 8000) and ragged cases, and batch 16
   and 128 at cut 64600, C 128, K 251. Error against 1e-3 * max|plain|; the
   kernel's, the plain version's and a bf16 cuDNN composition's times (conv1d
   -> abs -> max_pool1d, information only) beside the bound;
3b. kernel K4 (the fused LFCC front end) against its plain version: the CPU
   tests' (2, 16000) and (1, 64600) (404 frames) at the 'high', 'default' and
   'highest' tiers, then batch 128 and 384 at cut 64600, 'high', and batch 128,
   'default'. Error against 1e-4 * max|plain| (and their ratio); the kernel's,
   the plain version's and a ``torch.stft`` (cuFFT) composition's times
   (information only) beside the bound, the largest of the tensor-core, f32
   and bytes times (the filterbank counted by its nonzero weights); the
   tier's figures: frames a warpgroup tile and a CTA, shared memory a CTA
   (the library's, held against the wrapper's formula), W ring stages, CTAs
   an SM, registers, spills and wgmma serialisation from build.log. Phases 2 to 3b run with TF32 off in cuDNN and cuBLAS, so the plain
   versions are exact f32;
3d. K3's backward kernel (``ops/sinc_fused.py:sinc_abs_pool_bwd``, d filters)
   against its plain version at 'tf32' (cuDNN TF32) and '3xtf32' (exact f32):
   the CPU tests' cases, the training batch 12 at cut 64600, C 256 / K 129,
   C 16 / K 7 and an exact-tie case; the cotangent is zeroed at the near-tie
   triples (``sinc_fused.near_tie_mask``) on both sides, and d filters must
   agree within 2e-3 * max ('tf32') or 1e-4 * max ('3xtf32'); at batch 12
   both sides' error and bias against the same steps in f64; the kernel's,
   the plain version's and autograd's (through the composition, information
   only) times beside the bound; then K3's and the backward's registers,
   spills and wgmma serialisation from build.log;
3c. K3's trainable wrapper (``ops/sinc_fused.py:sinc_abs_pool``: K3 forward,
   the backward kernel for d filters, the f32 composition's VJP for d x) at
   (2, 8000), (3, 8001) and the training batch 12 at cut 64600, TF32 off: its
   forward against K3's plain version (1e-3 * max), d filters (one backward
   kernel launch) against the plain backward with the near-tie triples
   zeroed, d x against autograd through the composition (1e-4 * max); then,
   with cuDNN's defaults as the bf16 models run it, its forward and backward
   times, the plain versions', the composition's forward + backward
   (information only) and both bounds;
4. the main path, for maze5, maze5_fmsl, main, main_fmsl, lcnn_lfcc,
   lcnn1d_lfcc and resnet18_logmel: a synthetic
   ASVspoof fixture with 40 eval utterances goes through
   ``adfmsl_torch.cli.evaluate`` at full width, cut 64600 and batch 16 (a
   ragged last batch; RawNet with ``--fused_frontend``); the score file must
   hold one finite score per protocol utterance in protocol order, the EER
   must be printed, and the kernels must have launched as the path says: K1
   5 times per batch for maze5 and 6 for RawNet, K3 once per RawNet batch,
   none of them for the LFCC / log-mel models, and K4 on no evaluate path
   (the models' front end is the composition, as in adfmsl). Every count is
   set to 0 just before a path and read just after it;
4b. K4 as lcnn1d_lfcc's front end at batch 128, cut 64600: ``model.classify``
   of the kernel's LFCC against ``model(x)``, within 3e-2 * max(1, |logits|),
   with exactly one K4 launch (the count set to 0 just before); then both
   front ends' times and both forwards' utt/s: the median and spread of six
   windows of about 3 s each, taken in turns;
5. throughput: maze5 and maze5_fmsl folded vs unfolded trunk at batch 128
   (logits held against each other on 4 clips first); main at batch 16 with
   the K3 front end and with the composition (logits held against each other
   first), and at batch 128 (composition front end, K1 trunk); lcnn1d_lfcc at
   batch 128 and 384, lcnn_lfcc and resnet18_logmel at 128 (the median and
   spread of five windows of about 3 s each), each with the front end / trunk
   / head split of a forward (``profile_eval``, the median of 5);
6. kernel K2 (the BN + ReLU train backward, one cooperative launch) against
   its plain version: the CPU tests' (2, 700, 128) f32 and (3, 1000, 128)
   bf16 cases, maze5's block0 at batch 16 and 128 and block4's bn2 at batch
   12, bf16. Errors beside their tolerances (dx per element: one bf16 ulp of
   |dx| + 1e-3 * max|dx|, or 1e-5 * (|dx| + max|dx|) in f32; dgamma / dbeta:
   1e-4 * max, 1e-5 in f32), the kernel's and the plain version's times, the
   bound (6 bytes an element: x and dz read, dx written) and the two-pass
   traffic (10 bytes), the host's time to enqueue a call and the kernel's
   device time from ``torch.profiler`` (at small N the host's is the larger,
   and the events read it), the kernel's layout (``ops/bn_relu_bwd.py:
   kernel_config``: rows a stage, ring stages, CTAs, stages a CTA), the bytes
   its design moves (the two-pass traffic less the stages pass 2 finds still
   in the ring) and the achieved GB/s of both byte counts; for information,
   a device copy of x and dz (what the card reaches), and autograd's backward
   through ``F.batch_norm(training=True)`` + ``relu`` on the strided (B, C, T)
   transpose and on the contiguous (N, C) view. Then K2's entry point,
   ``adfmsl_torch.measure_bn_relu_bwd``, runs in-process, its launch count
   checked (one a backward);
7. training, for maze5, maze5_fmsl, main, main_fmsl, lcnn_lfcc, lcnn1d_lfcc
   and resnet18_logmel at full width: a synthetic fixture of 48 train and 24
   dev utterances goes through ``adfmsl_torch.cli.train`` at cut 64600 and
   batch 12 for one epoch without a dev set, then with ``--restore`` and the
   dev set for a second. What the CLI wrote is read back and checked:
   epoch_0 after the first run, then epoch_1 alone (best-1 retention drops
   epoch 0, whose missing dev metric ranks worst); finite losses, no skipped
   step, 4 and then 8 steps and updates, every parameter and BN running
   statistic moved, K3 never launched (the CLI sets no fused training front
   end, as adfmsl's); then ``cli.evaluate --model_path`` on it with the flags
   and launch counts of the model's main path (K1 5 a batch for maze5, 6 and
   K3 1 a batch for RawNet with ``--fused_frontend``, none for the LFCC /
   log-mel models);
7b. RawNet's fused training front end, for main and main_fmsl: a ``Trainer``
   built in-process with ``exp.model.extra['fused_train_frontend']`` trains
   one epoch of the fixture at batch 12, cut 64600, with K3 and its backward
   kernel each launched exactly once a train step (the counts set to 0 just
   before); then, from the same
   weights and batch with the randomness off, one step against the
   composition front end: loss within 5e-2 relative, global gradient cosine
   >= 0.85 (adfmsl's bounds, tests/test_models.py:327-337);
8. one f32 train step of maze5 and of main at batch 2, cut 16000, randomness
   off, on the card and on the CPU from the same weights (TF32 off): loss
   within 1e-4 relative, gradients as in tests/test_torch_train_step.py
   (cosine >= 0.999, norm within 1 % for leaves of 1 % of the global norm or
   more);
9. train throughput (bf16, the configurations' randomness on) of maze5 and
   maze5_fmsl at batch 12 and 32; of main and main_fmsl at batch 12 with the
   composition front end and with K3, and at batch 32 with the composition;
   of lcnn_lfcc, lcnn1d_lfcc and resnet18_logmel at batch 12 and 32. utt/s
   over 5 timed steps after 2 warm ones, ending in a synchronize (the LFCC /
   log-mel models, host-bound: the median and spread of five windows of
   about 3 s), with the peak memory; then ``torch.profiler`` over 3 more
   steps: the device's busy share, the step's device time split by its
   forward / backward / update labels (``train/steps.py``), and the
   operators and kernels with the most device time and the operators with
   the most host time;
10. a ``kernels`` line: every ported kernel with its launches on the main
   paths (K2's on its entry point, K4's as lcnn1d_lfcc's front end, K3's and
   its backward kernel's in the fused train steps too), its max error, its
   time at the main path's shapes beside its plain version's time, its bound
   and the library call's time (none exists).

Each phase prints its seconds, and a ``phase_seconds`` line the total. The
last line is ``{"ok": true, "device": {...}}``. Any failed check raises
before it. ``--only kernels`` runs the build and phases 2-3d, ends with a
``kernels_phase`` line (K1's times summed over maze5's and main's blocks, K3's,
its backward's and K4's main-path records) and prints no ``{"ok": ...}`` line: it is the quick
loop for kernel work, not a smoke run. ``--only k2`` builds K2's library
alone and runs phase 6's cases (not its entry point), ending with a
``k2_phase`` line and no ``{"ok": ...}`` line; copied into another checkout
of the port, it measures that checkout's K2 the same way. Without a card, or
without the repo beside this script, the run exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import math
import os
import re
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
K2_CASES = [  # name, B, T, C, dtype
    ("jax_case_f32", 2, 700, 128, torch.float32),
    ("two_tiles_bf16", 3, 1000, 128, torch.bfloat16),
    ("maze5_block0_b16", 16, 64350, 128, torch.bfloat16),
    ("maze5_block0_b128", 128, 21450, 128, torch.bfloat16),
    ("maze5_block4_bn2_b12", 12, 4022, 256, torch.bfloat16)]
PEAK_F32_FLOPS = 67e12            # H100 SXM data sheet, f32 outside the tensor cores
K2_OPS_PER_ELEMENT = 20           # f32 operations of both passes, per element
K2_MEASURE_ITERS = 10
TRAIN_UTTS, DEV_UTTS, TRAIN_BATCH = 48, 24, 12
THROUGHPUT_BATCHES, WARM_STEPS, TIMED_STEPS = (12, 32), 2, 5
# K3's trainable wrapper (forward K3, d filters the backward kernel, d x the f32
# composition's VJP)
K3_TRAIN_CASES = [("jax_case", 2, 8000), ("ragged", 3, 8001),
                  (f"b{TRAIN_BATCH}_cut{CUT}", TRAIN_BATCH, CUT)]
# the backward kernel (ops/sinc_fused.py:sinc_abs_pool_bwd): name, B, T, C, K; each
# at both precisions, d filters within K3_BWD_TOL * max of the plain version's once
# the near-tie triples (sinc_fused.near_tie_mask) are zeroed on both sides
K3_BWD_CASES = [("jax_case", 2, 8000, SINC_C, SINC_K), ("ragged", 3, 8001, SINC_C, SINC_K),
                (f"b{TRAIN_BATCH}_cut{CUT}", TRAIN_BATCH, CUT, SINC_C, SINC_K),
                ("c256_k129", 3, 5000, 256, 129), ("c16_k7", 3, 5000, 16, 7),
                ("ties", 2, 8000, SINC_C, SINC_K)]
K3_BWD_TOL = {"tf32": 2e-3, "3xtf32": 1e-4}
K3_BWD_PASSES = {"tf32": 1, "3xtf32": 3}
PEAK_TF32_FLOPS = 495e12          # H100 SXM data sheet, dense TF32
# models trained through cli.train: (model, evaluate flags, K1 and K3 launches
# per batch evaluating the checkpoint), as MAIN_PATHS gives them
TRAIN_MODELS = ["maze5", "maze5_fmsl", "main", "main_fmsl", "lcnn_lfcc", "lcnn1d_lfcc",
                "resnet18_logmel"]
# train throughput: (model, label, batch, model extras); the LFCC / log-mel
# models' steps take a few ms and are host-bound, so their utt/s is the
# median of SPECTRAL_WINDOWS windows of about SPECTRAL_WINDOW_S seconds
K3_TRAIN = {"fused_train_frontend": True}
TRAIN_THROUGHPUT = (
    [(n, f"b{b}", b, {}) for n in ("maze5", "maze5_fmsl") for b in THROUGHPUT_BATCHES]
    + [(n, label, b, extra) for n in ("main", "main_fmsl")
       for label, b, extra in ((f"b{TRAIN_BATCH}_composition", TRAIN_BATCH, {}),
                               (f"b{TRAIN_BATCH}_k3", TRAIN_BATCH, K3_TRAIN),
                               ("b32_composition", 32, {}))]
    + [(n, f"b{b}", b, {}) for n in ("lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel")
       for b in THROUGHPUT_BATCHES])
SPECTRAL_MODELS = ("lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel")
# adfmsl's own bounds for the fused training front end against the
# composition (tests/test_models.py:327-337)
FUSED_TRAIN_LOSS_REL, FUSED_TRAIN_GRAD_COS = 5e-2, 0.85
# (model, extra CLI flags, K1, K3 and K4 launches per batch); the LFCC / log-mel
# models' front end is the composition (ops/lfcc.py), as in adfmsl
MAIN_PATHS = [("maze5", [], 5, 0, 0), ("maze5_fmsl", [], 5, 0, 0),
              ("main", ["--fused_frontend"], 6, 1, 0),
              ("main_fmsl", ["--fused_frontend"], 6, 1, 0),
              ("lcnn_lfcc", [], 0, 0, 0), ("lcnn1d_lfcc", [], 0, 0, 0),
              ("resnet18_logmel", [], 0, 0, 0)]
# K4 (fused LFCC) at the model's front-end widths (FrontendConfig's defaults)
SR, N_FFT, HOP, WIN, N_FILTER, N_LFCC = 16000, 512, 160, 400, 70, 60
N_BINS = N_FFT // 2 + 1
K4_CASES = [(f"{name}_{p}", b, t, p)       # name, B, T, precision tier
            for name, b, t in (("jax_case", 2, 16000), ("ragged_404_frames", 1, CUT))
            for p in ("high", "default", "highest")
            ] + [(f"b{b}_cut{CUT}_high", b, CUT, "high") for b in (BENCH_BATCH, 384)
                 ] + [(f"b{BENCH_BATCH}_cut{CUT}_default", BENCH_BATCH, CUT, "default")]
K4_TC_PASSES = {"high": 3, "default": 1, "highest": 0}    # bf16 DFT passes per tier
# eval throughput of the LFCC / log-mel models: (model, batches)
SPECTRAL_THROUGHPUT = [("lcnn1d_lfcc", (BENCH_BATCH, 384)), ("lcnn_lfcc", (BENCH_BATCH,)),
                       ("resnet18_logmel", (BENCH_BATCH,))]
# their forwards take a few ms and the shared host's launches set much of the
# pace, which drifts between and within runs: their utt/s is the median of
# several windows of a few seconds each, reported with its spread
SPECTRAL_WINDOW_S, SPECTRAL_WINDOWS = 3.0, 5
K4_FRONTEND_TURNS = ("composition", "k4", "k4", "composition") * 3


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 5, warm: int = 2, runs: int = 3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls in a
    row, then one synchronize, the median of ``runs`` such runs after ``warm``
    calls. The calls queue behind each other, so where the card is slower than
    the host's wrappers the host's time between launches does not count."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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


def k1_build_report():
    """(Cin, Cout) -> registers a thread, spill store bytes and whether ptxas
    serialised the wgmma products, for each K1 instantiation, read from the
    ``-Xptxas -v`` report that ops/_build.py keeps beside the library."""
    from adfmsl_torch.ops import _build

    log = (_build.library_path("resblock_eval").parent / "build.log").read_text()
    serialized = set(re.findall(r"C7512\).*?for the function '(\S+)'", log))
    report = {}
    for m in re.finditer(r"Compiling entry function '(\S*resblock_eval_kernelILi(\d+)ELi(\d+)E"
                         r"\S*)'.*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S):
        name, cin, cout, spill, regs = m.groups()
        report[(int(cin), int(cout))] = {"registers_per_thread": int(regs),
                                         "spill_store_bytes": int(spill),
                                         "wgmma_serialized": name in serialized}
    return report


def k1_figures(rf):
    """(Cin, Cout) -> K1's figures for that instantiation: tile rows, shared
    memory a CTA, threads, CTAs an SM, weight-ring stages, L2 weight bytes per
    output row, and the build report's registers, spills and serialisation."""
    report = k1_build_report()
    figs = {}
    for cin, cout, skip in rf.KERNEL_SHAPES:
        c = rf.kernel_config(cin, cout, skip)
        figs[(cin, cout)] = {
            "tile_rows": c["rows"], "smem_bytes_per_cta": c["smem_bytes"],
            "threads_per_cta": c["threads"], "ctas_per_sm": c["ctas_per_sm"],
            "stages": c["stages"],
            "l2_weight_bytes_per_row": c["weight_bytes_per_tile"] / c["rows"],
            **report.get((cin, cout), {"registers_per_thread": None})}
    return figs


def k1_case(rf, figs, name, b, t, cin, cout, pre, skip, act, pool, seed, dev):
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
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           **figs[(cin, cout)]}
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


def k4_bound(b, t, precision, fb_nonzeros):
    """(tensor_ms, f32_ms, bytes_ms): the DFT's bf16 passes at the tier on the
    tensor cores; the f32 work on the CUDA cores (the power, the filterbank's
    ``fb_nonzeros`` weights, the dense DCT, and at 'highest' the DFT itself);
    x, the DFT matrix at the tier's width, the filterbank and the DCT read once
    and the output written once at the HBM rate. The two pipes run at the same
    time, so the bound is the largest of the three, not a sum."""
    frames = b * (1 + t // HOP)
    dft = 2.0 * frames * WIN * 2 * N_BINS
    f32_ops = frames * (3.0 * N_BINS + 2.0 * fb_nonzeros + 2.0 * N_FILTER * N_LFCC)
    if precision == "highest":
        f32_ops += dft
    tensor_ms = K4_TC_PASSES[precision] * dft / PEAK_BF16_FLOPS * 1e3
    w_bytes = WIN * 2 * N_BINS * {"high": 4, "default": 2, "highest": 4}[precision]
    nbytes = 4 * b * t + w_bytes + 4 * N_BINS * N_FILTER + 4 * N_FILTER * N_LFCC \
        + 4 * frames * N_LFCC
    return tensor_ms, f32_ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def stft_composition(dev):
    """LFCC as ``torch.stft`` (cuFFT) -> power -> filterbank -> log -> DCT:
    timed beside K4 for information only; the port never calls it."""
    from adfmsl_torch.ops.lfcc import dct_matrix
    from adfmsl_torch.ops.mel import linear_filterbank
    from adfmsl_torch.ops.window import hann

    window = torch.from_numpy(hann(WIN)).to(dev)
    fb = torch.from_numpy(linear_filterbank(SR, N_FFT, N_FILTER)).to(dev)
    dct = torch.from_numpy(dct_matrix(N_FILTER, N_LFCC)).to(dev)

    def run(x):
        spec = torch.stft(x, N_FFT, HOP, WIN, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec.abs().square().transpose(1, 2)
        return torch.log(torch.clamp(power @ fb, min=1e-6)) @ dct
    return run


K4_KERNELS = {"high": "lfcc_tc_kernelILi1E", "default": "lfcc_tc_kernelILi0E",
              "highest": "lfcc_highest_kernel"}     # each tier's entry function


def k4_figures(lf):
    """Tier -> K4's figures at the model's shape: frames a warpgroup tile and a
    CTA, shared memory a CTA, W ring stages, threads, CTAs an SM (from the
    library, held against the wrapper's ``tc_smem_layout``), and the build
    report's registers, spills and wgmma serialisation."""
    report = build_report("lfcc_fused", "lfcc_")
    figs = {}
    for p, tag in K4_KERNELS.items():
        c = lf.kernel_config(p, SR, N_FFT, HOP, WIN, N_FILTER, N_LFCC)
        if p != "highest":
            words = lf.kernel_operands(SR, N_FFT, WIN, N_FILTER, N_LFCC, p,
                                       torch.device("cpu")).fb_words
            want = lf.tc_smem_layout(HOP, WIN, N_FILTER, N_LFCC, p, words)
            check((c["smem_bytes"], c["stages"], c["cta_frames"]) ==
                  (want["total"], want["stages"], want["warpgroups"] * c["tile_frames"]),
                  f"K4 {p}: the library's shared memory {c} differs from the wrapper's {want}")
        figs[p] = {"tile_frames": c["tile_frames"], "cta_frames": c["cta_frames"],
                   "smem_bytes_per_cta": c["smem_bytes"], "stages": c["stages"],
                   "threads_per_cta": c["threads"], "ctas_per_sm": c["ctas_per_sm"],
                   **next((v for k, v in report.items() if tag in k),
                          {"registers_per_thread": None})}
    return figs


def k4_case(lf, comp, fb_nonzeros, figs, name, b, t, precision, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t), generator=g, device=dev)
    out = lf.lfcc_fused(x, precision=precision)
    torch.cuda.synchronize()
    want = lf.lfcc_fused_plain(x, precision=precision)
    check(tuple(out.shape) == tuple(want.shape) == (b, 1 + t // HOP, N_LFCC),
          f"K4 {name}: shape {tuple(out.shape)}")
    err = (out - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    comp_err = (comp(x) - want).abs().max().item()
    del out, want
    plain_ms = cuda_ms(lambda: lf.lfcc_fused_plain(x, precision=precision))
    ms = cuda_ms(lambda: lf.lfcc_fused(x, precision=precision))
    composition_ms = cuda_ms(lambda: comp(x))
    tensor_ms, f32_ms, bytes_ms = k4_bound(b, t, precision, fb_nonzeros)
    ops_ms = max(tensor_ms, f32_ms)
    rec = {"case": name, "B": b, "T": t, "precision": precision, "frames": 1 + t // HOP,
           "max_abs_err": err, "tol": tol, "err_over_tol": err / tol,
           "kernel_ms": ms, "plain_ms": plain_ms, "stft_composition_ms": composition_ms,
           "stft_composition_max_abs_diff": comp_err,
           "tensor_ms": tensor_ms, "f32_ms": f32_ms, "filterbank_nonzeros": fb_nonzeros,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **figs[precision]}
    print("K4 " + json.dumps(rec), flush=True)
    check(math.isfinite(err) and err <= tol, f"K4 {name}: error {err} > {tol}")
    del x
    torch.cuda.empty_cache()
    return rec


def sinc_filters_at_init(dev):
    """The (C, K) filters of a freshly initialised RawNet front end."""
    from adfmsl_torch.ops.sinc import sinc_filters, sinc_init

    low, band = sinc_init(SINC_C)
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), SINC_K).to(dev)


def build_report(lib, kernel):
    """Registers a thread, spill store bytes and whether ptxas serialised the
    wgmma products, for each entry function of library ``lib`` whose name
    holds ``kernel``, from the ``-Xptxas -v`` report ops/_build.py keeps."""
    from adfmsl_torch.ops import _build

    log = (_build.library_path(lib).parent / "build.log").read_text()
    serialized = set(re.findall(r"C7520\).*?in the function '(\S+)'", log))
    report = {}
    for m in re.finditer(r"Compiling entry function '(\S*" + kernel + r"\S*)'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S):
        name, spill, regs = m.groups()
        report[name] = {"registers_per_thread": int(regs), "spill_store_bytes": int(spill),
                        "wgmma_serialized": name in serialized}
    return report


def sinc_case_input(name, b, t, seed, dev):
    """0.1 * N(0, 1) audio; the ``ties`` case adds a constant stretch (pool
    triples of z bit-equal: the gradient splits three ways) and a silent one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.1 * torch.randn((b, t), generator=g, device=dev)
    if name == "ties":
        x[:, 1000:2500] = 0.05
        x[:, 3000:4200] = 0.0
    return x, g


def k3_bwd_case(sf, name, b, t, c, k, precision, seed, dev):
    """The backward kernel (d filters) against its plain version under the
    cuDNN setting of the composition it stands in for (TF32 for 'tf32', exact
    f32 for '3xtf32'), the cotangent zeroed at near-tie triples on both sides;
    then the kernel's, the plain version's and autograd's (through the
    composition, information only) times beside the bound."""
    from adfmsl_torch.ops.sinc import sinc_abs_pool3_nhc, sinc_filters, sinc_init

    low, band = sinc_init(c)
    f = sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k).to(dev)
    x, g = sinc_case_input(name, b, t, seed, dev)
    cot = torch.randn((b, (t - k + 1) // 3, c), generator=g, device=dev)
    near = sf.near_tie_mask(x, f, precision)
    cot = torch.where(near, 0.0, cot)
    n_near = int(near.sum())
    del near
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=precision == "tf32"):
        got = sf.sinc_abs_pool_bwd(x, f, cot, precision)
        torch.cuda.synchronize()
        want = sf.sinc_abs_pool_bwd_plain(x, f, cot, precision)
        err = (got - want).abs().max().item()
        tol = K3_BWD_TOL[precision] * want.abs().max().item()
        ms = cuda_ms(lambda: sf.sinc_abs_pool_bwd(x, f, cot, precision))
        plain_ms = cuda_ms(lambda: sf.sinc_abs_pool_bwd_plain(x, f, cot, precision))
        fr = f.clone().requires_grad_(True)
        autograd_ms = cuda_ms(lambda: torch.autograd.grad(sinc_abs_pool3_nhc(x, fr), (fr,),
                                                          cot))
    accuracy = {}
    if b == TRAIN_BATCH:            # both sides against the same steps in f64
        ref = sf.sinc_abs_pool_bwd_plain(x.double(), f.double(), cot.double())
        scale = ref.abs().max().item()
        accuracy = {f"{side}_vs_f64_over_max": (v.double() - ref).abs().max().item() / scale
                    for side, v in (("kernel", got), ("plain", want))}
        accuracy.update({f"{side}_bias_vs_f64_over_max":
                         ((v.double() - ref) * ref.sign()).mean().item() / scale
                         for side, v in (("kernel", got), ("plain", want))})
        del ref
    ops_ms, bytes_ms = k3_train_bound(b, t, c, k, PEAK_TF32_FLOPS / K3_BWD_PASSES[precision])
    rec = {"case": name, "precision": precision, "B": b, "T": t, "C": c, "K": k,
           "near_tie_triples_zeroed": n_near, "triples": b * ((t - k + 1) // 3) * c,
           "max_abs_err": err, "tol": tol, **accuracy, "kernel_ms": ms, "plain_ms": plain_ms,
           "composition_autograd_ms": autograd_ms,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print("K3_bwd " + json.dumps(rec), flush=True)
    check(math.isfinite(err) and err <= tol,
          f"K3 backward {name} {precision}: error {err} > {tol}")
    del x, f, cot, got, want
    torch.cuda.empty_cache()
    return rec


def phase_kernels(rf, sf, lf, dev):
    """K1, K3 and K4 against their plain versions, TF32 off so those are f32
    (K4's plain version rounds its operands to bf16 itself at 'high' and
    'default', where TF32 products are exact); then K3's backward kernel at
    both precisions (``k3_bwd_case``)."""
    from adfmsl_torch.ops.mel import linear_filterbank

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            figs = k1_figures(rf)
            k1 = [k1_case(rf, figs, *c, seed=i, dev=dev) for i, c in enumerate(K1_CASES)]
            filters = sinc_filters_at_init(dev)
            k3 = [k3_case(sf, filters, *c, seed=i, dev=dev)
                  for i, c in enumerate(K3_CASES)]
            comp = stft_composition(dev)
            fb_nonzeros = int(np.count_nonzero(linear_filterbank(SR, N_FFT, N_FILTER)))
            k4_figs = k4_figures(lf)
            k4 = [k4_case(lf, comp, fb_nonzeros, k4_figs, *c, seed=i, dev=dev)
                  for i, c in enumerate(K4_CASES)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    k3b = [k3_bwd_case(sf, *c, precision=p, seed=30 + i, dev=dev)
           for i, c in enumerate(K3_BWD_CASES) for p in K3_BWD_TOL]
    figs = {**build_report("sinc_abs_pool", "sinc_abs_pool_kernel"),
            **build_report("sinc_abs_pool_bwd", "sinc_bwd_kernel")}
    return k1, k3, k3b, k4, figs


def k3_train_bound(b, t, c, k, peak_flops):
    """(ops_ms, bytes_ms) of the trainable wrapper's backward: the recompute's
    forward and its weight gradient, 2*B*T'*C*K products each, at
    ``peak_flops`` (the precision the recompute runs at); x and the cotangent
    read once and d filters written once at the HBM rate."""
    t_out = t - k + 1
    flops = 2 * 2.0 * b * t_out * c * k
    nbytes = 4 * b * t + 4 * b * (t_out // 3) * c + 4 * c * k
    return flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3


def k3_train_case(sf, filters, name, b, t, seed, dev):
    """The trainable wrapper on the card, TF32 off: its forward against K3's
    plain version (1e-3 * max); d filters (the backward kernel at '3xtf32', one
    launch a backward) against the plain backward with the near-tie triples'
    cotangent zeroed on both sides (1e-4 * max); d x against autograd through
    the f32 composition (1e-4 * max). Then its times with cuDNN's defaults, as
    the bf16 models' front end runs (the backward kernel at 'tf32')."""
    from adfmsl_torch.ops.sinc import sinc_abs_pool3_nhc

    g = torch.Generator(device=dev).manual_seed(seed)
    c, k = filters.shape
    x = 0.1 * torch.randn((b, t), generator=g, device=dev)
    cot = torch.randn((b, (t - k + 1) // 3, c), generator=g, device=dev)
    cot = torch.where(sf.near_tie_mask(x, filters, "3xtf32"), 0.0, cot)
    f = filters.clone().requires_grad_(True)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        xr = x.clone().requires_grad_(True)
        y = sf.sinc_abs_pool(xr, f, True)
        before = sf.sinc_abs_pool_bwd.launches
        dx, df = torch.autograd.grad(y, (xr, f), cot)
        torch.cuda.synchronize()
        check(sf.sinc_abs_pool_bwd.launches == before + 1,
              f"K3-train {name}: the backward kernel launched "
              f"{sf.sinc_abs_pool_bwd.launches - before} times in one backward")
        want_y = sf.sinc_abs_pool_plain(x, filters)
        want_df = sf.sinc_abs_pool_bwd_plain(x, filters, cot, "3xtf32")
        xw = x.clone().requires_grad_(True)
        (want_dx,) = torch.autograd.grad(sinc_abs_pool3_nhc(xw, filters), (xw,), cot)
    errs = {}
    for what, got, want, rel in (("y", y, want_y, 1e-3), ("dfilters", df, want_df, 1e-4),
                                 ("dx", dx, want_dx, 1e-4)):
        check(tuple(got.shape) == tuple(want.shape), f"K3-train {name}: {what} shape")
        errs[what] = ((got - want).abs().max().item(), rel * want.abs().max().item())
    del y, dx, df, want_y, want_dx, want_df, xr, xw
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        fwd_ms = cuda_ms(lambda: sf.sinc_abs_pool(x, f))
        plain_fwd_ms = cuda_ms(lambda: sf.sinc_abs_pool_plain(x, filters))
        y = sf.sinc_abs_pool(x, f)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (f,), cot, retain_graph=True))
        plain_bwd_ms = cuda_ms(lambda: sf.sinc_abs_pool_bwd_plain(x, filters, cot, "tf32"))
        del y

        def composition():
            return torch.autograd.grad(sinc_abs_pool3_nhc(x, f), (f,), cot)
        composition_ms = cuda_ms(composition)
    fwd_ops, fwd_bytes = k3_bound(b, t, c, k)
    bwd_ops, bwd_bytes = k3_train_bound(b, t, c, k, PEAK_TF32_FLOPS)
    rec = {"case": name, "B": b, "T": t, "C": c, "K": k,
           **{f"max_abs_err_{w}": e for w, (e, _) in errs.items()},
           **{f"tol_{w}": tl for w, (_, tl) in errs.items()},
           "forward_ms": fwd_ms, "backward_ms": bwd_ms, "ms": fwd_ms + bwd_ms,
           "plain_forward_ms": plain_fwd_ms, "plain_backward_ms": plain_bwd_ms,
           "plain_ms": plain_fwd_ms + plain_bwd_ms,
           "composition_fwd_bwd_ms": composition_ms,
           "backward_precision": "tf32 (cuDNN's default, as the bf16 models run it)",
           "forward_bound_ms": max(fwd_ops, fwd_bytes),
           "backward_bound_ms": max(bwd_ops, bwd_bytes),
           "ops_ms": fwd_ops + bwd_ops, "bytes_ms": fwd_bytes + bwd_bytes,
           "bound_ms": max(fwd_ops, fwd_bytes) + max(bwd_ops, bwd_bytes),
           "bound_by": "operations" if fwd_ops + bwd_ops >= fwd_bytes + bwd_bytes else "bytes"}
    print("K3_train " + json.dumps(rec), flush=True)
    for what, (e, tl) in errs.items():
        check(math.isfinite(e) and e <= tl, f"K3-train {name}: {what} error {e} > {tl}")
    del x, cot, f
    torch.cuda.empty_cache()
    return rec


def phase_k3_train(sf, dev):
    """K3's trainable wrapper (``ops/sinc_fused.py:sinc_abs_pool``) at the CPU
    tests' cases and at the training batch, cut 64600."""
    filters = sinc_filters_at_init(dev)
    return [k3_train_case(sf, filters, *c, seed=20 + i, dev=dev)
            for i, c in enumerate(K3_TRAIN_CASES)]


def phase_main_path(name, flags, k1_per_batch, k3_per_batch, k4_per_batch, rf, sf, lf,
                    fixture, tmp):
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
    lf.lfcc_fused.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_launches = rf.resblock_eval.launches
    k3_launches = sf.sinc_abs_pool_fused.launches
    k4_launches = lf.lfcc_fused.launches
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
    check(k4_launches == k4_per_batch * n_batches,
          f"{name}: K4 launched {k4_launches} times, expected {k4_per_batch * n_batches}")
    rec = {"model": name, "flags": flags, "utterances": len(ids), "batch": EVAL_BATCH,
           "batches": n_batches, "k1_launches": k1_launches,
           "k3_launches": k3_launches, "k4_launches": k4_launches,
           "eer": metrics[-1]["eer"], "wall_s": wall_s}
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


def windowed_rates(fns, x, order):
    """utt/s of each forward in ``fns`` (key -> callable) over windows of about
    ``SPECTRAL_WINDOW_S`` seconds, sized from 5 forwards each, taken in
    ``order`` (a sequence of keys) so that a drift of the shared host's speed
    hits each alike. Returns {key: {median, min, max, windows, reps}}."""
    reps = {k: max(5, math.ceil(SPECTRAL_WINDOW_S * 1e3 / forward_rate(fn, x)[1]))
            for k, fn in fns.items()}
    rates = {k: [] for k in fns}
    for k in order:
        rates[k].append(forward_rate(fns[k], x, reps[k])[0])
    return {k: {"median": float(np.median(r)), "min": min(r), "max": max(r),
                "windows": r, "reps": reps[k]} for k, r in rates.items()}


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


def phase_k4_frontend(lf, dev, card):
    """K4 as lcnn1d_lfcc's front end at batch 128: ``model.classify`` of the
    kernel's LFCC against ``model(x)`` (the composition front end), K4
    launched exactly once for the batch; then both front ends' times and
    both forwards' utt/s over windows taken in turns (``K4_FRONTEND_TURNS``)."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.ops.cmvn import cmvn

    exp = make_experiment("lcnn1d_lfcc")
    fe = exp.model.frontend
    model = build_model(exp.model, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(4)
    x = 0.1 * torch.randn((BENCH_BATCH, CUT), generator=g, device=dev)

    def k4_features(x):
        feats = lf.lfcc_fused(x, exp.model.architecture.sample_rate, fe.n_fft,
                              fe.hop_length, fe.win_length, fe.n_filter, fe.n_lfcc,
                              fe.log_eps, precision=fe.dsp_precision)
        return cmvn(feats) if fe.cmvn else feats

    def k4_forward(x):
        return model.classify(k4_features(x))

    with torch.inference_mode():
        lf.lfcc_fused.launches = 0
        lk = k4_forward(x)["logits"].float()
        torch.cuda.synchronize()
        launches = lf.lfcc_fused.launches
        lc = model(x)["logits"].float()
        feat_err = (k4_features(x) - model.features(x)).abs().max().item()
        feat_tol = 1e-4 * model.features(x).abs().max().item()
    err = (lk - lc).abs().max().item()
    tol = 3e-2 * max(1.0, lc.abs().max().item())
    rec = {"model": "lcnn1d_lfcc", "card": card, "batch": BENCH_BATCH, "cut": CUT,
           "precision": fe.dsp_precision, "k4_launches": launches,
           "features_max_abs_err": feat_err, "features_tol": feat_tol,
           "logits_k4_vs_composition_max_abs_err": err, "tol": tol}
    check(launches == 1, f"lcnn1d_lfcc: K4 launched {launches} times for one batch")
    check(math.isfinite(feat_err) and feat_err <= feat_tol,
          f"lcnn1d_lfcc: K4 features differ from the composition's by {feat_err}")
    check(math.isfinite(err) and err <= tol,
          f"lcnn1d_lfcc: K4-front-end logits differ by {err} > {tol}")
    with torch.inference_mode():
        rec["frontend_ms_k4"] = cuda_ms(lambda: k4_features(x))
        rec["frontend_ms_composition"] = cuda_ms(lambda: model.features(x))
    runs = windowed_rates({"composition": model, "k4": k4_forward}, x, K4_FRONTEND_TURNS)
    for key, r in runs.items():
        rec[f"utt_per_s_{key}"] = r
    rec["k4_over_composition_medians"] = runs["k4"]["median"] / runs["composition"]["median"]
    print("k4_frontend " + json.dumps(rec), flush=True)
    del model, x
    torch.cuda.empty_cache()
    return rec


def phase_throughput_spectral(dev, card):
    """Eval utt/s of the LFCC / log-mel models on random audio, with the front
    end / trunk / head split of a forward (``profile_eval.stage_times``, the
    median of 5)."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.profile_eval import stage_times

    recs = []
    for name, batches in SPECTRAL_THROUGHPUT:
        model = build_model(make_experiment(name).model, device=dev, seed=0)
        rec = {"model": name, "card": card, "cut": CUT}
        for b in batches:
            g = torch.Generator(device=dev).manual_seed(5)
            x = 0.1 * torch.randn((b, CUT), generator=g, device=dev)
            rates = windowed_rates({name: model}, x, (name,) * SPECTRAL_WINDOWS)[name]
            with torch.inference_mode():
                splits = [stage_times(model, x) for _ in range(5)]
            st = {k: float(np.median([sp[k] for sp in splits])) for k in splits[0]}
            rec[f"b{b}"] = {"utt_per_s": rates["median"], "utt_per_s_windows": rates,
                            "forward_ms": b / rates["median"] * 1e3, "stages_ms": st,
                            "frontend_share": st["frontend"] / st["forward"]}
            del x
        print("throughput " + json.dumps(rec), flush=True)
        recs.append(rec)
        del model
        torch.cuda.empty_cache()
    return recs


def k2_bound(b, t, c, elem):
    """(ops_ms, bytes_ms, two_pass_ms): K2's f32 elementwise work at the f32
    peak; x and dz read once and dx written once at the HBM rate (the bound);
    and the two-pass design's traffic (x and dz read twice)."""
    n = b * t * c
    return (K2_OPS_PER_ELEMENT * n / PEAK_F32_FLOPS * 1e3,
            3 * elem * n / PEAK_BYTES * 1e3, 5 * elem * n / PEAK_BYTES * 1e3)


def k2_host_device_ms(fn, reps: int = 5):
    """(host_ms, device_ms) a call of K2's wrapper: the host's time to enqueue
    ``reps`` calls in a row (no synchronize), and the device time of the
    kernels whose name holds ``bn_relu`` from ``torch.profiler``. Where the
    host's time is the larger, CUDA events around calls in a row read it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages() if "bn_relu" in e.key)
    return host_ms, device_us / reps / 1e3


def k2_layout(k2, n, c, dtype, dev):
    """(layout, design_bytes): ``kernel_config`` on this card (rows a stage,
    ring stages, CTAs, the fewest and most stages a CTA, shared memory) and
    the HBM bytes the design moves: x and dz read in pass 1, read again in
    pass 2 but for the stages still in the ring, dx written (re-reads that
    hit L2 still count). (None, None) for a checkout whose K2 has no
    ``kernel_config`` (the two-kernel form before it)."""
    if not hasattr(k2, "kernel_config"):
        return None, None
    card = k2.card_layout(c, dtype, dev.index)
    cfg = k2.kernel_config(n, c, dtype, card["n_sm"], card["ctas_per_sm"])
    rows, s = cfg["rows_per_stage"], cfg["stages"]
    counts = [e - f for f, e in cfg["stage_ranges"]]
    resident = sum(min(e * rows, n) - max(f, e - s) * rows for f, e in cfg["stage_ranges"])
    elem = torch.finfo(dtype).bits // 8
    layout = {"rows_per_stage": rows, "stages": s, "ctas": cfg["ctas"],
              "ctas_per_sm": card["ctas_per_sm"], "n_sm": card["n_sm"],
              "stages_per_cta": [min(counts), max(counts)],
              "smem_bytes": cfg["smem_bytes"], "threads": cfg["threads"],
              "rows_still_in_ring": resident}
    return layout, elem * c * (5 * n - 2 * resident)


def k2_case(k2, name, b, t, c, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, c), generator=g, device=dev).to(dtype)
    gamma = torch.empty(c, device=dev).uniform_(0.5, 1.5, generator=g)
    beta = torch.empty(c, device=dev).uniform_(-0.3, 0.3, generator=g)
    dz = torch.randn((b, t, c), generator=g, device=dev).to(dtype)
    _, mu, rstd = k2.bn_relu_forward(x, gamma, beta)
    got = k2.bn_relu_bwd(x, dz, gamma, beta, mu, rstd)
    torch.cuda.synchronize()
    want = k2.bn_relu_bwd_plain(x, dz, gamma, beta, mu, rstd)
    gx, wx = got[0].float(), want[0].float()
    scale = wx.abs().max().item()
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(wx.abs().clamp_min(1e-30))) - 7)
        bound, tol_dx, rel = ulp + 1e-3 * scale, 1e-3 * scale, 1e-4
    else:
        bound, tol_dx, rel = 1e-5 * wx.abs() + 1e-5 * scale, 1e-5 * scale, 1e-5
    diff = (gx - wx).abs()
    err_dx, excess = diff.max().item(), (diff - bound).max().item()
    over_bound = (diff / bound).max().item()
    err_dg, err_db = ((a - w).abs().max().item() for a, w in zip(got[1:], want[1:]))
    tol_dg, tol_db = (rel * w.abs().max().item() for w in want[1:])
    del got, want, gx, wx, diff, bound
    ms = cuda_ms(lambda: k2.bn_relu_bwd(x, dz, gamma, beta, mu, rstd))
    host_ms, device_ms = k2_host_device_ms(lambda: k2.bn_relu_bwd(x, dz, gamma, beta, mu, rstd))
    plain_ms = cuda_ms(lambda: k2.bn_relu_bwd_plain(x, dz, gamma, beta, mu, rstd))
    src = torch.cat([x.reshape(-1), dz.reshape(-1)])
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    leaves = [x.clone().requires_grad_(True), gamma.clone().requires_grad_(True),
              beta.clone().requires_grad_(True)]
    y = torch.relu(F.batch_norm(leaves[0].transpose(1, 2), None, None, leaves[1],
                                leaves[2], training=True, eps=1e-5))
    dzt = dz.transpose(1, 2)
    composition_ms = cuda_ms(lambda: torch.autograd.grad(y, leaves, dzt, retain_graph=True))
    del y, leaves
    leaves = [x.reshape(-1, c).clone().requires_grad_(True),
              gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)]
    y = torch.relu(F.batch_norm(leaves[0], None, None, leaves[1], leaves[2],
                                training=True, eps=1e-5))
    dzn = dz.reshape(-1, c)
    composition_nc_ms = cuda_ms(lambda: torch.autograd.grad(y, leaves, dzn,
                                                            retain_graph=True))
    del y, leaves
    elem = x.element_size()
    ops_ms, bytes_ms, two_pass_ms = k2_bound(b, t, c, elem)
    layout, design_bytes = k2_layout(k2, b * t, c, dtype, dev)
    n_bytes = 3 * elem * b * t * c
    rec = {"case": name, "B": b, "T": t, "C": c, "dtype": str(dtype).split(".")[-1],
           "max_abs_err_dx": err_dx, "tol_dx": tol_dx, "dx_excess_over_bound": excess,
           "dx_max_err_over_bound": over_bound,
           "max_abs_err_dgamma": err_dg, "tol_dgamma": tol_dg,
           "max_abs_err_dbeta": err_db, "tol_dbeta": tol_db,
           "kernel_ms": ms, "kernel_device_ms": device_ms, "host_ms_per_call": host_ms,
           "plain_ms": plain_ms, "autograd_bn_relu_bwd_ms": composition_ms,
           "autograd_bn_relu_bwd_nc_ms": composition_nc_ms,
           "device_copy_ms": copy_ms, "device_copy_gb_per_s": 4 * elem * b * t * c / copy_ms / 1e6,
           "bound_at_copy_rate_ms": copy_ms * 3 / 4,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "two_pass_bytes_ms": two_pass_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_gb_per_s": n_bytes / ms / 1e6, "design_bytes": design_bytes,
           "design_gb_per_s": design_bytes / ms / 1e6 if design_bytes else None,
           "layout": layout}
    print("K2 " + json.dumps(rec), flush=True)
    check(math.isfinite(excess) and excess <= 0, f"K2 {name}: dx beyond its bound by {excess}")
    check(math.isfinite(err_dg) and err_dg <= tol_dg, f"K2 {name}: dgamma {err_dg} > {tol_dg}")
    check(math.isfinite(err_db) and err_db <= tol_db, f"K2 {name}: dbeta {err_db} > {tol_db}")
    del x, dz
    torch.cuda.empty_cache()
    return rec


def phase_k2(k2, dev):
    """K2 against its plain version (TF32 plays no part: no products), then
    its entry point, the measurement module, with the launches counted."""
    from adfmsl_torch import measure_bn_relu_bwd as mb

    recs = [k2_case(k2, *c, seed=i, dev=dev) for i, c in enumerate(K2_CASES)]
    print("k2_build " + json.dumps(build_report("bn_relu_bwd", "bn_relu")), flush=True)
    k2.bn_relu_bwd.launches = 0
    t0 = time.perf_counter()
    res = mb.run("both", iters=K2_MEASURE_ITERS)
    torch.cuda.synchronize()
    launches = k2.bn_relu_bwd.launches
    # two shapes x two kernel programs x (2 warm + timed) backwards, one launch each
    expected = len(mb.SHAPES) * 2 * (2 + K2_MEASURE_ITERS)
    entry = {"entry_point": "python -m adfmsl_torch.measure_bn_relu_bwd both",
             "iters": K2_MEASURE_ITERS, "launches": launches, "expected": expected,
             "wall_s": time.perf_counter() - t0, "ms": res}
    print("k2_entry " + json.dumps(entry), flush=True)
    check(launches == expected, f"K2 launched {launches} times at its entry point, "
                                f"expected {expected}")
    return recs, entry


def phase_train(name, rf, k2, sf, fixture, tmp, dev):
    """cli.train for one epoch, then --restore for a second, each checked
    through the files it wrote; then cli.evaluate --model_path on the
    checkpoint, with ``MAIN_PATHS``' flags and launch counts; returns the
    run's record."""
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.models import build_model, load_checkpoint
    from adfmsl_torch.train import CheckpointManager
    from adfmsl_torch.train.checkpoint import TRAIN_STATE_FILE

    ck = os.path.join(tmp, f"{name}_ck")
    mgr = CheckpointManager(ck)
    tr, dv = fixture["train"], fixture["dev"]
    argv = ["--model", name, "--train_protocol", tr["protocol"], "--train_dir",
            tr["audio_dir"], "--batch_size", str(TRAIN_BATCH), "--checkpoint_dir", ck,
            "--device", dev.type]
    dev_argv = ["--dev_protocol", dv["protocol"], "--dev_dir", dv["audio_dir"]]
    steps_per_epoch = TRAIN_UTTS // TRAIN_BATCH
    rf.resblock_eval.launches = 0
    k2.bn_relu_bwd.launches = 0
    sf.sinc_abs_pool_fused.launches = 0
    t0 = time.perf_counter()
    hist, models = [], {}
    # the first epoch has no dev set (the default dev protocol is looked up in
    # a directory that does not exist), so its NaN dev metric ranks below the
    # second's and best-1 retention must keep epoch 1 alone
    no_dev = ["--protocols_path", os.path.join(tmp, f"{name}_no_protocols")]
    for epoch, extra in ((0, ["--num_epochs", "1"] + no_dev),
                         (1, ["--num_epochs", "2", "--restore"] + dev_argv)):
        rc = cli_train.main(argv + extra)
        torch.cuda.synchronize()
        check(rc == 0, f"{name}: cli.train {extra} exited {rc}")
        epochs = mgr.all_epochs()
        check(epochs == [epoch], f"{name}: retained epochs {epochs} after epoch {epoch}")
        met = mgr.metrics(epoch)
        hist.append({"epoch": epoch, **met})
        check(math.isfinite(met["train_loss"]) and met["skipped"] == 0
              and math.isfinite(met["dev_acc"]) == (epoch == 1),
              f"{name}: epoch {epoch} metrics {met}")
        path = os.path.join(ck, f"epoch_{epoch}")
        ts = torch.load(os.path.join(path, TRAIN_STATE_FILE), map_location="cpu",
                        weights_only=True)
        n = steps_per_epoch * (epoch + 1)
        check(ts["step"] == n and ts["optimizer"]["count"] == n,
              f"{name}: {ts['step']} steps, {ts['optimizer']['count']} updates after "
              f"epoch {epoch}, expected {n}")
        exp, models[epoch] = load_checkpoint(path, map_location="cpu")
    wall_s = time.perf_counter() - t0
    k1_train, k2_train = rf.resblock_eval.launches, k2.bn_relu_bwd.launches
    k3_train = sf.sinc_abs_pool_fused.launches
    # the CLI sets no fused training front end, as adfmsl's: K3 stays idle
    check(k3_train == 0, f"{name}: K3 launched {k3_train} times in cli.train")
    init = build_model(exp.model, device="cpu", seed=exp.train.seed).state_dict()
    for a, b, what in ((init, models[0], "epoch 0"), (models[0], models[1], "epoch 1")):
        still = [k for k, v in b.items() if not k.endswith("num_batches_tracked")
                 and torch.equal(v, a[k])]
        check(not still, f"{name}: unmoved by {what}: {still}")

    ev = fixture["eval"]
    out = os.path.join(tmp, f"{name}_trained_scores.txt")
    _, flags, k1_per_batch, k3_per_batch, _ = next(p for p in MAIN_PATHS if p[0] == name)
    rf.resblock_eval.launches = 0
    sf.sinc_abs_pool_fused.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(["--model_type", name, "--model_path", ck, "--protocol",
                            ev["protocol"], "--data_dir", ev["audio_dir"], "--output", out,
                            "--batch_size", str(EVAL_BATCH), "--device", dev.type, *flags])
    torch.cuda.synchronize()
    k1_eval, k3_eval = rf.resblock_eval.launches, sf.sinc_abs_pool_fused.launches
    check(rc == 0, f"{name}: evaluate of the checkpoint exited {rc}")
    with open(out) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()]
    check([ln[0] for ln in lines] == ev["utt_ids"]
          and bool(np.isfinite([float(ln[1]) for ln in lines]).all()),
          f"{name}: score file of the trained model")
    n_batches = -(-EVAL_UTTS // EVAL_BATCH)
    check(k1_eval == k1_per_batch * n_batches,
          f"{name}: K1 launched {k1_eval} times evaluating the checkpoint, expected "
          f"{k1_per_batch * n_batches}")
    check(k3_eval == k3_per_batch * n_batches,
          f"{name}: K3 launched {k3_eval} times evaluating the checkpoint, expected "
          f"{k3_per_batch * n_batches}")
    rec = {"model": name, "cut": CUT, "batch": TRAIN_BATCH, "train_utts": TRAIN_UTTS,
           "dev_utts": DEV_UTTS, "epochs": hist, "steps": 2 * steps_per_epoch,
           "retained_epochs": mgr.all_epochs(), "k1_launches_training": k1_train,
           "k2_launches_training": k2_train, "k3_launches_training": k3_train,
           "evaluate_flags": flags, "k1_launches_evaluate": k1_eval,
           "k3_launches_evaluate": k3_eval, "wall_s": wall_s}
    print("train " + json.dumps(rec), flush=True)
    return rec


def phase_fused_train(name, sf, fixture, dev):
    """RawNet's fused training front end through the ``Trainer``, built
    in-process with ``exp.model.extra['fused_train_frontend']`` (no CLI flag
    sets it, as in adfmsl): one epoch of the fixture at batch 12, cut 64600,
    with K3 and its backward kernel each launched exactly once a train step
    (the counts set to 0 just before). Then, from the same weights and batch with the randomness off,
    one step against the composition front end: loss within 5e-2 relative and
    global gradient cosine >= 0.85, adfmsl's bounds (tests/test_models.py:
    327-337)."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import (Optimizer, Trainer, TrainState, make_dataset_and_loader,
                                    make_train_step)

    exp = make_experiment(name)
    exp.train.batch_size, exp.train.num_epochs, exp.train.log_every_steps = TRAIN_BATCH, 1, 0
    exp.model.extra.update(K3_TRAIN)
    tr = fixture["train"]
    loader = make_dataset_and_loader(exp, parse_protocol(tr["protocol"], exp.data.label_polarity),
                                     tr["audio_dir"], shuffle=True)
    trainer = Trainer(exp, loader, None, device=dev)
    sf.sinc_abs_pool_fused.launches = sf.sinc_abs_pool_bwd.launches = 0
    t0 = time.perf_counter()
    (epoch,) = trainer.fit()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, steps = sf.sinc_abs_pool_fused.launches, trainer.state.step
    bwd_launches = sf.sinc_abs_pool_bwd.launches
    check(steps == TRAIN_UTTS // TRAIN_BATCH and launches == steps,
          f"{name}: K3 launched {launches} times in {steps} fused train steps")
    check(bwd_launches == steps,
          f"{name}: K3's backward kernel launched {bwd_launches} times in {steps} "
          "fused train steps")
    check(math.isfinite(epoch.train_loss) and epoch.skipped_batches == 0,
          f"{name}: fused training epoch {epoch}")
    del trainer

    g = torch.Generator(device=dev).manual_seed(6)
    x = 0.1 * torch.randn((TRAIN_BATCH, CUT), generator=g, device=dev)
    y = (torch.arange(TRAIN_BATCH, device=dev) % 2).long()
    m = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
    loss, grads = {}, {}
    for key, extra in (("k3", K3_TRAIN), ("composition", {})):
        e = make_experiment(name)
        e.model.extra.update(extra)
        if e.model.fmsl is not None:
            e.model.fmsl.proj_dropout, e.model.fmsl.enable_lsa = 0.0, False
        model = build_model(e.model, device=dev, seed=0)
        st = TrainState(model, Optimizer(e.train.optimizer, model.parameters(), 10, 1), seed=0)
        met = make_train_step(e)(st, x, y, m, st.generators(0, 0))
        check(float(met["skipped"]) == 0.0, f"{name}: {key} step skipped")
        loss[key], grads[key] = float(met["loss"]), _grads(st, met)
        del model, st
    a = np.concatenate(list(grads["k3"].values()))
    b = np.concatenate([grads["composition"][k] for k in grads["k3"]])
    cos = float(a @ b) / float(np.linalg.norm(a) * np.linalg.norm(b))
    rel = abs(loss["k3"] - loss["composition"]) / abs(loss["composition"])
    rec = {"model": name, "batch": TRAIN_BATCH, "cut": CUT, "steps": steps,
           "k3_launches": launches, "k3_bwd_launches": bwd_launches,
           "train_loss": epoch.train_loss, "wall_s": wall_s,
           "loss_k3": loss["k3"], "loss_composition": loss["composition"],
           "loss_rel_diff": rel, "loss_tol": FUSED_TRAIN_LOSS_REL,
           "grad_cosine": cos, "grad_cosine_min": FUSED_TRAIN_GRAD_COS}
    print("fused_train " + json.dumps(rec), flush=True)
    check(math.isfinite(rel) and rel <= FUSED_TRAIN_LOSS_REL,
          f"{name}: fused-front-end loss differs by {rel}")
    check(math.isfinite(cos) and cos >= FUSED_TRAIN_GRAD_COS,
          f"{name}: fused-front-end gradient cosine {cos}")
    del x
    torch.cuda.empty_cache()
    return rec


def _grads(state, metrics):
    clip, norm = state.optimizer.clip, float(metrics["grad_norm"])
    factor = clip / norm if clip and norm >= clip else 1.0
    return {n: p.grad.detach().float().cpu().numpy().ravel() / factor
            for n, p in state.model.named_parameters()}


def phase_train_card_vs_cpu(name, dev):
    """One f32 step of ``name`` on the card and on the CPU from the same init."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import Optimizer, TrainState, make_train_step

    exp = make_experiment(name)
    exp.data.cut, exp.model.dtype = 16000, "float32"
    exp.model.architecture.dropout_rate = exp.model.architecture.fc_dropout = 0.0
    exp.model.spec_augment.enabled = False
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal((2, 16000))).astype(np.float32))
    y, m = torch.tensor([0, 1]), torch.ones(2, dtype=torch.bool)
    loss, grads = {}, {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for d in ("cpu", dev):
                model = build_model(exp.model, device=d, seed=0)
                st = TrainState(model, Optimizer(exp.train.optimizer, model.parameters(),
                                                 10, 5), seed=0)
                met = make_train_step(exp)(st, x.to(d), y.to(d), m.to(d))
                loss[str(d)], grads[str(d)] = float(met["loss"]), _grads(st, met)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    cpu, card = grads["cpu"], grads[str(dev)]
    gnorm = math.sqrt(sum(float(v @ v) for v in cpu.values()))
    worst_cos, worst_ratio, checked = 1.0, 0.0, 0
    for k, r in cpu.items():
        a = card[k]
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(r))
        if na < 3e-5 * gnorm and nb < 3e-5 * gnorm:
            continue
        cos = float(a @ r) / (na * nb)
        check(cos >= (0.999 if a.size >= 512 else 0.99),
              f"card vs CPU ({name}): {k} cosine {cos}")
        ratio_tol = 0.01 if nb >= 0.01 * gnorm else 0.05
        check(abs(na / nb - 1) <= ratio_tol, f"card vs CPU ({name}): {k} norm ratio {na / nb}")
        worst_cos, worst_ratio = min(worst_cos, cos), max(worst_ratio, abs(na / nb - 1))
        checked += 1
    rel = abs(loss[str(dev)] - loss["cpu"]) / abs(loss["cpu"])
    rec = {"model": name, "dtype": "float32", "batch": 2, "cut": 16000,
           "loss_card": loss[str(dev)], "loss_cpu": loss["cpu"], "loss_rel_err": rel,
           "leaves_checked": checked, "worst_grad_cosine": worst_cos,
           "worst_norm_ratio_dev": worst_ratio}
    print("train_card_vs_cpu " + json.dumps(rec), flush=True)
    check(rel <= 1e-4 and checked >= 20, f"card vs CPU ({name}): loss {rel}, {checked} leaves")
    return rec


def profile_steps(step, st, batch_args, first, steps=3, tops=False):
    """``torch.profiler`` over ``steps`` train steps: the device's busy share
    of the wall time, the step's device time split by its labels
    (``STEP_LABELS``) and, with ``tops``, the operators and kernels with the
    most device time and the operators with the most host time."""
    from torch.profiler import ProfilerActivity, profile

    from adfmsl_torch.train.steps import STEP_LABELS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(st, *batch_args, st.generators(0, first + i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def device_us(e, total=False):
        if total:
            return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def top(events, n):
        return [{"name": e.key[:120], "ms_per_step": device_us(e) / 1e3 / steps,
                 "calls_per_step": e.count / steps}
                for e in sorted(events, key=device_us, reverse=True)[:n]]
    events = prof.key_averages()
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    on_host = [e for e in events if not str(e.device_type).endswith("CUDA")]
    # a host-side label carries the device time of the kernels launched inside
    # its range on the calling thread
    labels = {e.key: device_us(e, total=True) / 1e3 / steps for e in on_host
              if e.key in STEP_LABELS}
    # device events are the kernels and copies (the labels' device-side spans
    # are left out); host events (aten ops) carry the device time of the
    # kernels they launched, counted a second time
    kernels = [e for e in on_device if device_us(e) > 0 and e.key not in STEP_LABELS]
    ops = [e for e in on_host if device_us(e) > 0 and e.key not in STEP_LABELS]
    device_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    fwd, bwd, upd = (labels.get(k, 0.0) for k in STEP_LABELS)
    rec = {"profiled_steps": steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           # autograd runs the backward's kernels on its own device thread,
           # outside the backward label's range: the backward is the rest
           "forward_ms": fwd, "update_ms": upd, "backward_ms": device_ms - fwd - upd,
           "backward_label_ms": bwd}
    check(fwd > 0 and upd > 0 and rec["backward_ms"] > 0,
          f"train step split: {rec}")
    if tops:
        host = sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
        rec.update(top_ops=top(ops, 15), top_kernels=top(kernels, 10),
                   # host time by operator, the profiler's own cost included
                   top_host_ops=[{"name": e.key[:120],
                                  "host_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                                  "calls_per_step": e.count / steps} for e in host])
    return rec


def train_rate(step, st, batch_args, first, n):
    """(utt/s, ms per step) of ``n`` train steps by the host clock around work
    that ends in a synchronize; every step must be finite and applied."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        met = step(st, *batch_args, st.generators(0, first + i))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(math.isfinite(float(met["loss"])) and float(met["skipped"]) == 0,
          "a timed train step was not finite or was skipped")
    return batch_args[0].shape[0] * n / secs, secs / n * 1e3


def phase_train_throughput(name, configs, dev, card):
    """Train utt/s of the real step for each (label, batch, model extras) of
    ``configs``, with the peak memory, then a profile of it
    (``profile_steps``). Sinc and RawNet models: 5 timed steps after 2 warm
    ones. The LFCC / log-mel models, host-bound: the median and spread of
    ``SPECTRAL_WINDOWS`` windows of about ``SPECTRAL_WINDOW_S`` seconds."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import Optimizer, TrainState, make_train_step

    rec = {"model": name, "card": card, "cut": CUT, "dtype": "bfloat16"}
    windowed = name in SPECTRAL_MODELS
    for label, batch, extra in configs:
        t0 = time.perf_counter()
        exp = make_experiment(name)
        exp.model.extra.update(extra)
        model = build_model(exp.model, device=dev, seed=0)
        st = TrainState(model, Optimizer(exp.train.optimizer, model.parameters(), 100, 5),
                        seed=0)
        step = make_train_step(exp)
        g = torch.Generator(device=dev).manual_seed(3)
        args = (0.1 * torch.randn((batch, CUT), generator=g, device=dev),
                (torch.arange(batch, device=dev) % 2).long(),
                torch.ones(batch, dtype=torch.bool, device=dev))
        torch.cuda.reset_peak_memory_stats(dev)
        train_rate(step, st, args, 0, WARM_STEPS)
        first = WARM_STEPS
        if windowed:
            reps = max(TIMED_STEPS, math.ceil(SPECTRAL_WINDOW_S * 1e3
                                              / train_rate(step, st, args, first,
                                                           TIMED_STEPS)[1]))
            first += TIMED_STEPS
            rates = []
            for _ in range(SPECTRAL_WINDOWS):
                rates.append(train_rate(step, st, args, first, reps)[0])
                first += reps
            timing = {"utt_per_s": float(np.median(rates)),
                      "utt_per_s_windows": {"median": float(np.median(rates)),
                                            "min": min(rates), "max": max(rates),
                                            "windows": rates, "reps": reps}}
            timing["step_ms"] = batch / timing["utt_per_s"] * 1e3
        else:
            rate, ms = train_rate(step, st, args, first, TIMED_STEPS)
            first += TIMED_STEPS
            timing = {"utt_per_s": rate, "step_ms": ms}
        rec[label] = {"batch": batch, "extra": extra, **timing,
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                      **profile_steps(step, st, args, first, tops=True),
                      "seconds": time.perf_counter() - t0}
        del model, st, args
        torch.cuda.empty_cache()
    print("train_throughput " + json.dumps(rec), flush=True)
    return rec


def _summed(recs):
    """Kernel, plain and bound times summed over ``recs`` (one forward's calls)."""
    ops_ms = sum(r["ops_ms"] for r in recs)
    bytes_ms = sum(r["bytes_ms"] for r in recs)
    return {"ms": sum(r["kernel_ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


K1_FIGURE_KEYS = ("tile_rows", "smem_bytes_per_cta", "threads_per_cta", "ctas_per_sm",
                  "stages", "l2_weight_bytes_per_row", "registers_per_thread",
                  "spill_store_bytes", "wgmma_serialized")


def _k1_instantiations(k1):
    """K1's figures for each (Cin, Cout) its cases ran."""
    out = {}
    for r in k1:
        out.setdefault(f"{r['cin']}->{r['cout']}", {k: r.get(k) for k in K1_FIGURE_KEYS})
    return out


def kernels_phase_line(k1, k3, k3b, k4, figs):
    """The ``kernels_phase`` record of ``--only kernels``: K1 summed over
    maze5's and main's blocks with its figures, K3, K3's backward (both
    precisions) and K4 at their main-path shapes, K3's build figures."""
    return {"kernels_phase": {
        "K1": {"maze5_blocks": _summed([r for r in k1 if r["case"].startswith("maze5_block")]),
               "main_blocks": _summed([r for r in k1 if r["case"].startswith("main_block")]),
               "max_err_over_tol": max(max(r["max_abs_err_y"] / r["tol_y"],
                                           r["max_abs_err_sums"] / r["tol_sums"])
                                       for r in k1),
               "instantiations": _k1_instantiations(k1)},
        "K3": _summed([next(r for r in k3 if r["B"] == EVAL_BATCH and r["T"] == CUT)]),
        f"K3_b{BENCH_BATCH}": _summed([next(r for r in k3 if r["B"] == BENCH_BATCH)]),
        **{f"K3_bwd_{p}": _summed([_k3_bwd_main(k3b, p)]) for p in K3_BWD_TOL},
        "K3_bwd_max_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in k3b),
        "K3_build": figs,
        "K4": {f"b{b}_{p}": {**_summed([r]), **{k: r[k] for k in K4_FIGURE_KEYS},
                             "composition_ms": r["stft_composition_ms"]}
               for b, p in ((BENCH_BATCH, "high"), (384, "high"), (BENCH_BATCH, "default"))
               for r in [_k4_main(k4, b, p)]},
        "K4_max_err_over_tol": max(r["err_over_tol"] for r in k4)}}


K4_FIGURE_KEYS = ("tile_frames", "cta_frames", "smem_bytes_per_cta", "stages",
                  "threads_per_cta", "ctas_per_sm", "registers_per_thread",
                  "spill_store_bytes", "wgmma_serialized")


def _k4_main(k4, b, precision):
    """K4's record at batch ``b``, cut 64600, ``precision``."""
    return next(r for r in k4 if r["B"] == b and r["T"] == CUT and r["precision"] == precision)


def _k3_bwd_main(k3b, precision):
    """The backward kernel's record at the training batch, cut 64600."""
    return next(r for r in k3b if r["precision"] == precision and r["B"] == TRAIN_BATCH
                and r["T"] == CUT)


def kernels_line(k1, k2, k2_entry, k3, k3b, k3_train, k4, k4_front, main_path, train,
                 fused_train):
    """The ``kernels`` record. K1: main-path launches (the evaluate paths and
    the evaluation of each trained checkpoint) and errors over all cases;
    times and bound summed over the five maze5 blocks, i.e. per maze5 forward
    at batch 128 (the six RawNet blocks beside them). K2: launches at its entry
    point (no model path reaches it, as in adfmsl), errors over all cases,
    times at maze5's block0 at batch 16 (batch 128 beside them). K3: its times
    at batch 16, the largest batch its dispatch gives it on the main path
    (batch 128 beside them); its launches on the evaluate paths and in the
    fused train steps. K3-bwd (the backward kernel of K3's trainable wrapper,
    for d filters): launches in the fused train steps, errors over its cases at
    both precisions, times at batch 12, cut 64600, 'tf32' (the bf16 models'
    precision; '3xtf32' beside them), beside the plain backward, autograd
    through the composition (information only) and the whole wrapper's
    forward + backward. K4: launches on its path as lcnn1d_lfcc's front end
    (the evaluate paths launch it no time, as adfmsl's ``lfcc`` never calls
    it), times at batch 128, cut 64600, 'high' (batch 384 beside them)."""
    k3_main = next(r for r in k3 if r["B"] == EVAL_BATCH and r["T"] == CUT)
    k4_main = _k4_main(k4, BENCH_BATCH, "high")
    k4_big = _k4_main(k4, 384, "high")
    k4_default = _k4_main(k4, BENCH_BATCH, "default")
    k3_big = next(r for r in k3 if r["B"] == BENCH_BATCH)
    k2_main = next(r for r in k2 if r["case"] == "maze5_block0_b16")
    k2_big = next(r for r in k2 if r["case"] == "maze5_block0_b128")

    def k2_times(r):
        return {"ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
                "host_ms_per_call": r["host_ms_per_call"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "two_pass_bound_ms": r["two_pass_bytes_ms"],
                "composition_ms": r["autograd_bn_relu_bwd_ms"],
                "composition_nc_ms": r["autograd_bn_relu_bwd_nc_ms"],
                "device_copy_ms": r["device_copy_ms"],
                "bound_at_copy_rate_ms": r["bound_at_copy_rate_ms"],
                "design_gb_per_s": r["design_gb_per_s"]}
    k1_train = {f"{r['model']} trained checkpoint": r["k1_launches_evaluate"] for r in train}
    k3_eval_train = {f"{r['model']} trained checkpoint": r["k3_launches_evaluate"]
                     for r in train}
    k3_fused = {f"{r['model']} fused training": r["k3_launches"] for r in fused_train}
    k3b_fused = {f"{r['model']} fused training": r["k3_bwd_launches"] for r in fused_train}
    k3b_main = {p: _k3_bwd_main(k3b, p) for p in K3_BWD_TOL}
    k3t_main = next(r for r in k3_train if r["B"] == TRAIN_BATCH and r["T"] == CUT)
    return {"kernels": [{
        "id": "K1", "name": "resblock_eval", "route": "cuda",
        "source": "adfmsl_torch/csrc/resblock_eval.cu",
        "replaces": "adfmsl/ops/pallas/resblock_fused.py:141",
        "launches": sum(r["k1_launches"] for r in main_path) + sum(k1_train.values()),
        "launches_by_path": {**{r["model"]: r["k1_launches"] for r in main_path},
                             **k1_train},
        "max_abs_err": max(r["max_abs_err_y"] for r in k1),
        "max_err_over_tol": max(max(r["max_abs_err_y"] / r["tol_y"],
                                    r["max_abs_err_sums"] / r["tol_sums"]) for r in k1),
        **_summed([r for r in k1 if r["case"].startswith("maze5_block")]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the folded block",
        "shapes": f"the five maze5 trunk blocks at batch {BENCH_BATCH}, cut {CUT}",
        "main_blocks": _summed([r for r in k1 if r["case"].startswith("main_block")]),
        "redesigned_shapes": sorted(_k1_instantiations(k1)),
        "instantiations": _k1_instantiations(k1),
    }, {
        "id": "K2", "name": "bn_relu_bwd", "route": "cuda",
        "source": "adfmsl_torch/csrc/bn_relu_bwd.cu",
        "replaces": "adfmsl/ops/pallas/bn_relu_bwd.py:100",
        "launches": k2_entry["launches"],
        "launches_by_path": {"measure_bn_relu_bwd": k2_entry["launches"],
                             **{f"{r['model']} training": r["k2_launches_training"]
                                for r in train}},
        "max_abs_err": max(r["max_abs_err_dx"] for r in k2),
        "max_err_over_tol": max(max(r["dx_max_err_over_bound"],
                                    r["max_abs_err_dgamma"] / r["tol_dgamma"],
                                    r["max_abs_err_dbeta"] / r["tol_dbeta"]) for r in k2),
        **k2_times(k2_main),
        "library_ms": None,
        "library_note": "no single PyTorch call computes relu(BN_train(x))'s backward; "
                        "autograd through F.batch_norm + relu is in composition_ms "
                        "((B, C, T) transpose) and composition_nc_ms ((N, C) view), "
                        "for information",
        "shapes": "maze5 block0 at batch 16, (16, 64350, 128) bf16",
        "b128": k2_times(k2_big),
        "layout": k2_main["layout"],
        "redesigned": "for Hopper: one cooperative launch, a producer warp's "
                      "cp.async.bulk x / dz ring, a grid barrier, pass 2 in reverse from "
                      "the ring and L2, streaming dx stores",
    }, {
        "id": "K3", "name": "sinc_abs_pool_fused", "route": "cuda",
        "source": "adfmsl_torch/csrc/sinc_abs_pool.cu",
        "replaces": "adfmsl/ops/pallas/sinc_fused.py:81",
        "launches": (sum(r["k3_launches"] for r in main_path) + sum(k3_eval_train.values())
                     + sum(k3_fused.values())),
        "launches_by_path": {**{r["model"]: r["k3_launches"] for r in main_path},
                             **k3_eval_train, **k3_fused},
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
    }, {
        "id": "K3-bwd", "name": "sinc_abs_pool_bwd", "route": "cuda",
        "source": "adfmsl_torch/csrc/sinc_abs_pool_bwd.cu",
        "replaces": "adfmsl/ops/pallas/sinc_fused.py:152 (_sap_bwd, the custom VJP of "
                    "sinc_abs_pool :138)",
        "launches": sum(k3b_fused.values()), "launches_by_path": k3b_fused,
        "max_abs_err": max(r["max_abs_err"] for r in k3b),
        "max_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in k3b),
        **_summed([k3b_main["tf32"]]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the VJP of max_pool3(|conv|); "
                        "autograd through the composition is in composition_ms, for "
                        "information",
        "composition_ms": k3b_main["tf32"]["composition_autograd_ms"],
        "near_tie_triples_zeroed": k3b_main["tf32"]["near_tie_triples_zeroed"],
        "shapes": f"batch {TRAIN_BATCH}, cut {CUT}, C {SINC_C}, K {SINC_K}, 'tf32'",
        "3xtf32": {**_summed([k3b_main["3xtf32"]]),
                   "composition_ms": k3b_main["3xtf32"]["composition_autograd_ms"]},
        "wrapper": {k: k3t_main[k] for k in ("ms", "plain_ms", "bound_ms", "forward_ms",
                                             "backward_ms", "composition_fwd_bwd_ms")},
        "wrapper_max_err_over_tol": max(max(r[f"max_abs_err_{w}"] / r[f"tol_{w}"]
                                            for w in ("y", "dfilters", "dx"))
                                        for r in k3_train),
    }, {
        "id": "K4", "name": "lfcc_fused", "route": "cuda",
        "source": "adfmsl_torch/csrc/lfcc_fused.cu",
        "replaces": "adfmsl/ops/pallas/lfcc_fused.py:94",
        "launches": k4_front["k4_launches"],
        "launches_by_path": {"lcnn1d_lfcc with K4 as its front end": k4_front["k4_launches"],
                             **{r["model"]: r["k4_launches"] for r in main_path}},
        "max_abs_err": max(r["max_abs_err"] for r in k4),
        "max_err_over_tol": max(r["err_over_tol"] for r in k4),
        **_summed([k4_main]),
        "bound_terms_ms": {k: k4_main[k] for k in ("tensor_ms", "f32_ms", "bytes_ms")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes LFCC; the torch.stft (cuFFT) "
                        "composition is in composition_ms, for information",
        "composition_ms": k4_main["stft_composition_ms"],
        "shapes": f"batch {BENCH_BATCH}, cut {CUT}, 'high', 404 frames x {N_LFCC}",
        "b384": {**_summed([k4_big]), "composition_ms": k4_big["stft_composition_ms"]},
        "default_b128": {**_summed([k4_default]),
                         "composition_ms": k4_default["stft_composition_ms"]},
        "redesigned": "for Hopper: register-A wgmma m64n64k16 on a pitched frame buffer, "
                      "a producer warp's cp.async.bulk W ring, re/im interleaved, sparse "
                      "filterbank ('high', 'default'; 'highest' keeps the CUDA-core form)",
        "figures": {p: {k: next(r for r in k4 if r["precision"] == p)[k]
                        for k in K4_FIGURE_KEYS} for p in K4_KERNELS},
    }]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels", "k2"], default=None,
                    help="kernels: only the build and the kernels phase; k2: only "
                         "K2's library and cases (no main path, no {\"ok\": ...} line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import adfmsl_torch

    check(Path(adfmsl_torch.__file__).resolve().parent == ROOT / "adfmsl_torch",
          f"adfmsl_torch imported from {adfmsl_torch.__file__}, not beside this script")
    from adfmsl_torch.data import SyntheticSpec, generate_fixture
    from adfmsl_torch.ops import _build
    from adfmsl_torch.ops import bn_relu_bwd as k2
    from adfmsl_torch.ops import lfcc_fused as lf
    from adfmsl_torch.ops import resblock_fused as rf
    from adfmsl_torch.ops import sinc_fused as sf

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t_start = time.perf_counter()
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return res

    if args.only == "k2":
        phase("build", _build.library_path, "bn_relu_bwd")
        recs = phase("k2", lambda: [k2_case(k2, *c, seed=i, dev=dev)
                                    for i, c in enumerate(K2_CASES)])
        print("phase_seconds " + json.dumps({**phase_s,
                                             "total": time.perf_counter() - t_start}))
        print(smi, flush=True)
        print(json.dumps({"k2_phase": {
            "source": str(ROOT), "build": build_report("bn_relu_bwd", "bn_relu"),
            **{r["case"]: {k: r[k] for k in ("kernel_ms", "kernel_device_ms",
                                               "host_ms_per_call", "plain_ms", "bound_ms",
                                               "device_copy_ms", "design_gb_per_s")}
               for r in recs}}}), flush=True)
        return 0
    libs = phase("build", _build.build_all)
    device = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": phase_s["build"], "libraries": sorted(libs)}
    print("device " + json.dumps(device), flush=True)

    k1, k3, k3b, k4, figs = phase("kernels", phase_kernels, rf, sf, lf, dev)
    if args.only == "kernels":
        print("phase_seconds " + json.dumps({**phase_s,
                                             "total": time.perf_counter() - t_start}))
        print(smi, flush=True)
        print(json.dumps(kernels_phase_line(k1, k3, k3b, k4, figs)), flush=True)
        return 0
    k3_train = phase("k3_train", phase_k3_train, sf, dev)
    k2_recs, k2_entry = phase("k2", phase_k2, k2, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = generate_fixture(tmp, SyntheticSpec(n_train=TRAIN_UTTS, n_dev=DEV_UTTS,
                                                      n_eval=EVAL_UTTS))
        main_path = phase("main_path", lambda: [
            phase_main_path(*p, rf, sf, lf, fixture, tmp) for p in MAIN_PATHS])
        train = phase("train", lambda: [phase_train(n, rf, k2, sf, fixture, tmp, dev)
                                        for n in TRAIN_MODELS])
        fused_train = phase("fused_train", lambda: [phase_fused_train(n, sf, fixture, dev)
                                                    for n in ("main", "main_fmsl")])
    k4_front = phase("k4_frontend", phase_k4_frontend, lf, dev, smi)
    phase("train_card_vs_cpu", lambda: [phase_train_card_vs_cpu(n, dev)
                                        for n in ("maze5", "main")])
    phase("train_throughput", lambda: [
        phase_train_throughput(n, [c[1:] for c in TRAIN_THROUGHPUT if c[0] == n], dev, smi)
        for n in dict.fromkeys(c[0] for c in TRAIN_THROUGHPUT)])
    phase("throughput", lambda: [phase_throughput(n, dev, smi)
                                 for n in ("maze5", "maze5_fmsl")])
    phase("throughput_main", phase_throughput_main, dev, smi)
    phase("throughput_spectral", phase_throughput_spectral, dev, smi)

    print("phase_seconds " + json.dumps({**phase_s,
                                         "total": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps(kernels_line(k1, k2_recs, k2_entry, k3, k3b, k3_train, k4, k4_front,
                                  main_path, train, fused_train)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
