#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adfmsl_torch``) on one CUDA card.

    python3 chip_smoke.py                   # every phase below
    python3 chip_smoke.py --only kernels    # phases 1 and 2-3f only
    python3 chip_smoke.py --only k2         # K2's library and cases only
    python3 chip_smoke.py --only multidevice   # the build and phase 7e only
    python3 chip_smoke.py --only config_cli    # the build and phase 7f only
    python3 chip_smoke.py --only reference_ckpt   # the build and phase 7g only
    python3 chip_smoke.py --only packs      # the build and phase 7h only
    python3 chip_smoke.py --only analysis   # the build and phase 7i only
    python3 chip_smoke.py --only wavlm      # the build and phase 4d only

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every kernel library from ``adfmsl_torch/csrc``
   (one ``nvcc`` per library, all started together);
2. kernel K1 (the folded eval residual-block body) against its plain PyTorch
   version on the card: the CPU tests' cases, block0 with ``pre`` and block4
   at batch 8, the wide stack heads (768 -> 128 and 1024 -> 128, 1x1 skip, no
   ``pre``) at T 67, 125 and 1, the five blocks of maze5 and the six RawNet
   blocks of main (LeakyReLU, MaxPool3) at batch 128 and cut 64600, and the
   blocks of maze7, maze3, maze2 and maze6 (the heads among them) at batch
   128 and T 201 into the trunk. Each line gives the max
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
3e. kernel K5 (maze5's eval front end: the TF32 sinc conv, first_bn and SELU,
   ``ops/sinc_bn_act.py``) against its plain version, the composition the
   model ran before K5, under cuDNN's TF32 as the bf16 models run it: batch 16
   and 128 at cut 64600, C 128, K 251, one count a call, every element within
   ``composition_gap``'s bound and at least ``K5_EQUAL_SHARE_FLOOR`` of them
   equal bit for bit; the
   kernel's and the composition's times beside the bound (the TF32 products
   or the bytes, the larger), and K5's registers and spills from build.log;
3f. kernel K6 (WavLM's gated relative-position attention core at eval,
   ``ops/wavlm_attention.py``) at the WavLM cell's shape (batch 16, 16 heads
   of 64, T' 1,499): one count a call, every element within
   ``composition_gap``'s bound of its plain version, the gap of each to the
   exact (f32) attention; the kernel's time beside the bound (the products
   at the bf16 peak, ``benchmark/benchlib/attention_roofline.py``'s), the
   plain version's (which gathers the bias table from the row each call) and
   the composition's as the model ran it (the table built once a forward);
   K6's registers and spills from build.log;
4. the main path, for maze5, maze5_fmsl, main, main_fmsl, lcnn_lfcc,
   lcnn1d_lfcc and resnet18_logmel: a synthetic
   ASVspoof fixture with 40 eval utterances goes through
   ``adfmsl_torch.cli.evaluate`` at full width, cut 64600 and batch 16 (a
   ragged last batch; RawNet with ``--fused_frontend``); the score file must
   hold one finite score per protocol utterance in protocol order, the EER
   must be printed, and the kernels must have launched as the path says: K1
   5 times per batch for maze5 and 6 for RawNet, K3 once per RawNet batch,
   K5 once per maze5 and maze5_fmsl batch, none of them for the LFCC /
   log-mel models, and K4 on no evaluate path (the models' front end is the
   composition, as in adfmsl). Every count is set to 0 (K5's always-on
   counter read) just before a path and read just after it;
4a. the Wav2Vec2 models' main path (``w2v2_main_path``): all ten of them,
   maze7, maze7_fmsl, maze3, maze2, maze2_fmsl, maze3_fmsl, maze6,
   maze6_fmsl, maze8 and maze8_fmsl, at full width (the base encoder, for
   maze6 / maze6_fmsl the large one with five taps fused; random init from
   seed 0), bf16, through ``adfmsl_torch.cli.evaluate`` on the same fixture
   and cut, K1 launched a batch 5 times for maze7, maze7_fmsl, maze6, maze8
   and maze8_fmsl, 6 for maze2 (its 768 -> 128 stack head included; maze6's
   is 1024 -> 128) and 3 for maze3, maze2_fmsl, maze3_fmsl and maze6_fmsl
   (``W2V2_PATHS``; T 201 frames into the trunk);
4d. maze6 on WavLM-Large (``wavlm_main_path``), built as the benchmark's
   ``maze6_wavlm`` cell builds it (``make_experiment('maze6')`` with
   ``WAVLM_OVERRIDES``, random init from seed 0) and saved as a checkpoint,
   through ``adfmsl_torch.cli.evaluate --model_path`` on the fixture at the
   cell's 30 s cut and batch 16, on two gloo ranks sharing the card: each
   rank's ``rank_summary`` (a fresh process, its counts from 0) must read K6,
   ``w2v2.fused_attention`` and ``w2v2.gated_layers`` 24 times a forward it
   ran, and the score file one finite score an utterance in protocol order;
   then the model in training (one forward with grad), after
   ``reset_kernel_launches``, launches no K6 and adds nothing to the counter;
4c. native audio IO (``native_io``): the fixture's eval split written again
   as FLAC (FIXED subframes, ``adfmsl_torch/data/flac.py``), maze5 through
   the evaluate CLI over the FLAC split and over the WAV one (K1 5 and K5 1
   a batch), whose score files must be byte for byte the same; then the loader's host rate: 256
   utterances of 4 s as FLAC and as 16-bit WAV, decoded and padded a batch of
   128 at a time by ``AsvspoofDataset.load_batch`` (``batch_decode_pad`` at 1,
   2, 4 and 8 native threads; the numpy WAV reader), the median of 3 passes
   over files in the page cache;
4b. K4 as lcnn1d_lfcc's front end at batch 128, cut 64600: ``model.classify``
   of the kernel's LFCC against ``model(x)``, within 3e-2 * max(1, |logits|),
   with exactly one K4 launch (the count set to 0 just before); then both
   front ends' times and both forwards' utt/s: the median and spread of four
   windows of about 3 s each, taken in turns;
4e. folded vs unfolded (``folded_vs_unfolded``), untimed: maze5, maze5_fmsl,
   maze7, maze3, maze2 and maze6 built twice with the same weights, the
   folded (K1) bf16 trunk's logits on 4 clips against the unfolded trunk's
   within 3e-2 * max(1, |logits|), K1 launched a forward as the model's path
   says (``MAIN_PATHS`` / ``W2V2_PATHS``) and never unfolded; then main with
   the K1 trunk: K3's logits against the composition front end's at batch 16
   (K3 once), and the composition front end at batch 128, as adfmsl's
   dispatch picks there, with finite scores and K1 6 times;
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
   and launch counts of the model's main path (K1 5 and K5 1 a batch for
   maze5, 6 and K3 1 a batch for RawNet with ``--fused_frontend``, none for
   the LFCC / log-mel models);
7a. ``w2v2_train``: the same for maze7 and maze2 (the encoder frozen, as
   their configs say) and maze6_fmsl (the large encoder unfrozen with
   ``unfreeze_last_n`` 2, its plateau scheduler on dev accuracy): every
   parameter the optimizer labels 'frozen' (``train/optim.py:param_labels``)
   must stay as initialised, and so must maze6_fmsl's FMSL prototypes and
   temperature (its 'replace' loss does not reach them, and AdamW's decay of
   them at lr 1e-5 rounds away in f32), every other parameter and BN
   statistic move, and exactly maze6_fmsl's last two encoder layers train; each checkpoint
   evaluated with its ``W2V2_PATHS`` K1 launches a batch;
7b. RawNet's fused training front end, for main and main_fmsl: a ``Trainer``
   built in-process with ``exp.model.extra['fused_train_frontend']`` trains
   one epoch of the fixture at batch 12, cut 64600, with K3 and its backward
   kernel each launched exactly once a train step (the counts set to 0 just
   before); then, from the same
   weights and batch with the randomness off, one step against the
   composition front end: loss within 5e-2 relative, global gradient cosine
   >= 0.85 (adfmsl's bounds, tests/test_models.py:327-337);
7c. activation checkpointing (``remat``): one train step plain and one
   checkpointed, from the same weights, batch and generators, bf16 with the
   configuration's randomness on: maze5 at batch 12 and main with K3 in the
   train forward at batch 12 under ``train.remat`` (the whole forward, as
   adfmsl), maze6 (the large encoder, random init, its last two layers
   trained) at batch 4 under ``remat_layers`` and ``remat_extractor``. The
   generators must end equal, the BN buffers and the loss agree within 1e-3,
   and the gradients as in phase 8; K1 no launch, K3 twice and its backward
   kernel once a checkpointed fused step (the recompute runs K3 again), once
   each a plain one. Then each variant's step ms over 5 steps after 2 warm
   ones and its peak memory (``max_memory_allocated``) beside the memory the
   model and optimizer hold;
7d. few-shot (``fewshot``): ``python -m adfmsl_torch.cli.fewshot --model
   maze5`` in a subprocess on the card, cut 64600, the CLI's default episodes
   (2-way, 5-shot, 5 queries, 4 episodes: 80 utterances a meta step), 3 meta
   steps on a 64-utterance train fixture, adapted to and scoring the
   40-utterance 'wild' fixture (``generate_wild_fixture``): the score file
   without the 10 support utterances, the EER, K1 5 times a maze5 eval
   forward (15: the adaptation and two scoring batches); the scores against
   the unfolded trunk's from the same trained weights within 3e-2 * max(1,
   |score|); the meta steps' seconds and the scoring rate;
   then the CLI again with ``--no_fused_trunk`` (K1 no launch);
7e. multi-device (``multidevice``; ranks started by
   ``adfmsl_torch.parallel.launch``, every count of kernel launches set to 0
   in each rank just before its path): (a) a world of one over NCCL: the
   data-parallel train step of maze5 at batch 12 (bf16, its randomness on)
   against the plain step from the same weights and generators: the loss
   equal, the parameters bitwise equal wherever two plain steps agree bitwise
   (else within Adam's 2.1 * lr), and both steps' ms; (b) ``python -m
   adfmsl_torch.cli.evaluate --data_parallel 2 --dist_backend gloo`` (two
   ranks sharing the card) on maze5 at batch 128: the one-process score
   file's ids and order, scores within 1e-5 * max(1, |s|) (a rank's rows are
   scored as in one process), K1 5 launches a batch on each rank; (c) two
   gloo ranks, 3 data-parallel steps of maze5 at a global batch of 12, f32,
   the randomness off, TF32 off, against the one-process steps on the same
   batches: each loss within 1e-4 relative,
   the first step's global gradient cosine >= 0.9999, the global update of
   the three steps at cosine >= 0.999 (AdamW's early steps are about
   lr * sign(g), so coordinates whose gradient sits at f32 noise flip: a CPU
   rehearsal at cut 8000 read 0.99984), the ranks' parameters bitwise equal;
   (d) two gloo ranks, RawNet main with ``fused_train_frontend`` at a global
   batch of 12 (6 rows a rank; K3 and its backward kernel are held against
   their plain versions at that shape in phases 2-3d): K3 and its backward
   kernel once a step on each rank, the first step against the one-process
   fused step (bf16) within 1e-2 relative loss and gradient cosine >= 0.95,
   and as a second witness the same step in f32 with TF32 off (the backward kernel at
   '3xtf32') within 1e-4 relative loss and gradient cosine >= 0.9999; (e)
   two gloo ranks, maze7's base encoder split tensor-parallel (12 heads -> 6
   a rank, FFN 3072 -> 1536) at batch 8 against the replicated forward
   within 3e-2 * max(1, |logit|). The two-rank times are printed as what
   they are: two ranks share one card and gloo stages through the host;
7f. the train CLI driven by config files (``config_cli``, run after 7b): (a)
   RawNet main from a YAML written by the port's ``save_yaml`` (batch 12, 2
   epochs, both kept, ``model.extra.fused_train_frontend``) through
   ``cli.train --config --log_dir --profile_dir`` on the fixture at cut
   64600: K3 and its backward kernel once a step (the counts set to 0 just
   before), ``experiment.yaml`` beside the checkpoints equal to the YAML after
   the CLI's path overrides and to ``model.pt``'s config, ``train/loss``,
   ``train/acc`` and ``dev/acc`` in ``metrics.jsonl`` at steps 0 and 1,
   finite and equal to each epoch's checkpoint metrics, one Chrome trace of
   the first epoch whose CUDA kernels include K3's and K3-bwd's
   ``__global__`` functions, and the step timer's report counting every step
   (``input`` once more an epoch: the wait that finds the loader's end); (b)
   maze5 from ``configs/maze5.yaml`` for one epoch, then ``cli.train --config
   --eval --restore`` from a copy with ``model.extra.fused_eval_trunk``: K1 5
   and K5 1 a batch on both paths, ``experiment.yaml`` left as it was, and the score file against
   ``cli.evaluate --model_path`` (its config from ``experiment.yaml``) at the
   same batch within 3e-2 * max(1, |score|). A line a part gives the
   launches, the seconds and the trace's bytes;
7g. reference checkpoints (``reference_ckpt``, run after 7f) on a fixture of
   16 eval, 24 train and 12 dev utterances at cut 64600: (a) thesis-style
   ``.pth`` files of maze5, maze5_fmsl, maze4_fmsl and main (main's a rich
   dict ``{"model_state_dict": ..., "epoch": 3}`` with 3 GRU layers), made by
   the independent torch models of ``tests/torch_ref_nets.py`` with random
   weights and BN statistics from a seeded generator, go through ``python -m
   adfmsl_torch.cli.convert_maze`` (no missing or unconsumed key) and
   ``cli.evaluate --model_path``; the score file must lie within atol 5e-4,
   rtol 1e-3 (adfmsl's promise for these checkpoints) of the torch model run
   on the card with TF32 off, on the audio as the CLI loads it, with no K1,
   K3, K3-bwd or K5 launch (the converted models are f32); beside it, the converted model's in-process gap with
   TF32 off in cuDNN (the CLI's trunk convs take cuDNN's TF32 default); (b) the
   converted main's ``experiment.yaml`` with ``fused_train_frontend`` and
   batch 12: ``cli.train --restore --eval`` scores the restored weights
   exactly as (a)'s file does, then ``cli.train --restore`` fine-tunes one
   epoch with K3 and K3-bwd ('3xtf32': the model is f32) once a step and
   finite losses, and from the converted weights, with the randomness off,
   one fused step against one through the composition front end (loss within
   5e-2 relative, gradient cosine >= 0.85, as 7b); (c) maze5 with 'reference'
   block semantics in bf16 and ``fused_eval_trunk``: K1 no launch, the scores
   bitwise those without the flag. A line a part gives the largest score
   differences, the launches and the seconds;
7h. packs (``packs``, run after 7g) on the same fixture at cut 64600: (a)
   ``python -m adfmsl_torch.cli.pack`` packs the eval split from its WAV
   files and from its FLAC twin (equal arrays), and maze5 scored by
   ``cli.evaluate --pack`` (K1 5 and K5 1 a batch, as from the files) writes the ``--data_dir`` run's
   score file byte for byte (the largest score difference printed); (b)
   RawNet main from a YAML with ``fused_train_frontend`` through ``cli.train
   --train_pack --dev_pack`` at batch 12 for 2 epochs (K3 and K3-bwd once a
   step), then ``--eval --eval_pack`` against ``--eval --eval_dir`` (equal
   score files); (c) a ``Trainer`` with ``data.augment_enabled``, the train
   pack's loader, a noise bank of 8 fixture clips and an RIR bank of 4
   ``synthetic_rir`` of length 2048, one epoch of 4 steps of RawNet main
   through K3 / K3-bwd (4 launches each), finite losses that differ from the
   same steps without banks, every gated-off row reaching the model bit for
   bit as loaded and every gated-on row changed; the gate rates, and the
   augmentation's ms (CUDA events) beside the step's with and without banks;
   (d) the 256 four-second FLAC utterances of 4c packed through the CLI:
   ``PackedDataset.load_batch``'s host utt/s at batch 128 (median of 3
   passes) beside 4c's FLAC rates at 1, 2, 4 and 8 threads and the decode
   rate the CLI printed; (e) ``cli.train --data_parallel 2 --dist_backend
   gloo --train_pack``, one epoch of 2 maze5 steps at a global batch of 12,
   the two ranks sharing the card: each rank's ``rank_summary`` line, exit 0;
7i. analysis (``analysis``, run after 7h; ``phase_analysis``) on a fixture of
   256 eval utterances at cut 64600: (a) maze5 and maze5_fmsl through
   ``cli.evaluate`` at batch 128 with and without ``--dump_embeddings`` (K1
   10 launches a run both times, byte-equal score files) and with
   ``--no_fused_trunk`` (features within 3e-3 * max(1, |x|), unit FMSL
   rows); (c) ``cli.batch`` of maze5 and main for one epoch at batch 12 (K3
   and K3-bwd once a main step, K1 5 a maze5 and 6 a main dev or eval batch);
   (b) ``cli.analyze`` with figures, embeddings and curves, its
   ``--regression 0.001`` gate (rc 2), ``cli.compare`` at 1,000 resamples;
   (d) the bootstrap's host seconds over 71,237 scores; (e) ``BNAct`` against
   the f32 BN -> SELU composition at (16, 21450, 128) bf16: errors, ms of the
   forward and of forward + backward, peak memory; (f) the base encoder's
   msgpack export, reload and ``cli.convert --verify``. A line a part;
8. one f32 train step of maze5 and of main at batch 2, cut 16000, randomness
   off, on the card and on the CPU from the same weights (TF32 off): loss
   within 1e-4 relative, gradients as in tests/test_torch_train_step.py
   (cosine >= 0.999, norm within 1 % for leaves of 1 % of the global norm or
   more);
10. a ``kernels`` line: every ported kernel with its launches on the main
   paths (K2's on its entry point, K4's as lcnn1d_lfcc's front end, K3's and
   its backward kernel's in the fused train steps too, K5's on every evaluate
   path above that counts it), its max error, its
   time at the main path's shapes beside its plain version's time, its bound
   and the library call's time (none exists); K1's also summed over maze7's,
   maze3's, maze2's and maze6's blocks at batch 128, and its cases at the
   wide stack heads (768 -> 128 and 1024 -> 128, the 1x1 skip, no ``pre``) at
   batch 128, T 201 and at ragged small T against the plain version; K1's
   launches on the few-shot path, K3's and its backward kernel's in the
   remat phase's fused steps, each rank's K1, K3 and K3-backward launches
   in the multidevice phase, and the config_cli, reference_ckpt and packs
   phases' K1, K3 and K3-backward launches among the launches by path.

Each phase prints its seconds, and a ``phase_seconds`` line the total. The
last line is ``{"ok": true, "device": {...}}``. Any failed check raises
before it. ``--only kernels`` runs the build and phases 2-3f, ends with a
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
import logging
import math
import os
import re
import signal
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
# maze7's and maze3's trunks at cut 64600: the base encoder's 320x extractor
# gives T = 201 frames; each stride-2 block halves it (ceil) before its body
MAZE7_BLOCKS = [(201, 128, 128, False, False), (101, 128, 128, True, False),
                (51, 128, 128, True, False), (26, 128, 128, True, False),
                (13, 128, 256, True, True)]
MAZE3_BLOCKS = [(101, 128, 128, False, False), (51, 128, 128, True, False),
                (26, 128, 256, True, True)]
# maze2's six blocks (the 768 -> 128 head on the base encoder's output) and
# maze6's five (the 1024 -> 128 head on the fused taps' 1x1 proj), T 201 in
MAZE2_BLOCKS = [(201, 768, 128, False, True), (101, 128, 128, True, False),
                (51, 128, 128, True, False), (26, 128, 128, True, False),
                (13, 128, 256, True, True), (7, 256, 256, True, False)]
MAZE6_BLOCKS = [(201, 1024, 128, False, True)] + MAZE7_BLOCKS[1:]
# the Wav2Vec2 models whose trunk blocks K1 is timed at (phase 2) and whose
# folded trunk is held against the unfolded one (phase 4e)
W2V2_K1_BLOCKS = (("maze7", MAZE7_BLOCKS), ("maze3", MAZE3_BLOCKS),
                  ("maze2", MAZE2_BLOCKS), ("maze6", MAZE6_BLOCKS))
K1_CASES = [  # name, B, T, Cin, Cout, pre, skip, act, pool
    ("head", 2, 100, 128, 128, False, False, "relu", 1),
    ("ragged", 2, 300, 128, 128, True, False, "relu", 1),
    ("skip1x1", 1, 77, 128, 256, True, True, "relu", 1),
    ("leaky_pool3", 2, 151, 128, 128, True, False, "leaky", 3),
    ("rawnet_256_pre", 2, 151, 256, 256, True, False, "leaky", 3),
    ("block0_pre_b8", 8, 64350, 128, 128, True, False, "relu", 1),
    ("block4_b8", 8, 4022, 128, 256, True, True, "relu", 1),
    ("head768_ragged", 2, 67, 768, 128, False, True, "relu", 1),
    ("head1024_ragged", 3, 125, 1024, 128, False, True, "relu", 1),
    ("head1024_t1", 2, 1, 1024, 128, False, True, "relu", 1),
] + [(f"maze5_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip,
     "relu", 1) for i, (t, cin, cout, pre, skip) in enumerate(MAZE5_BLOCKS)
] + [(f"main_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip,
     "leaky", 3) for i, (t, cin, cout, pre, skip) in enumerate(MAIN_BLOCKS)
] + [(f"{m}_block{i}_b{BENCH_BATCH}", BENCH_BATCH, t, cin, cout, pre, skip, "relu", 1)
     for m, blocks in W2V2_K1_BLOCKS for i, (t, cin, cout, pre, skip) in enumerate(blocks)]
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
WARM_STEPS, TIMED_STEPS = 2, 5
# the multidevice phase's global train batch and a data-parallel rank's rows of
# it on two ranks (phase 7e (c), (d))
MD_BATCH = TRAIN_BATCH
MD_RANK_BATCH = MD_BATCH // 2
# K3's trainable wrapper (forward K3, d filters the backward kernel, d x the f32
# composition's VJP), at the one-process and the two-rank training shapes
K3_TRAIN_CASES = [("jax_case", 2, 8000), ("ragged", 3, 8001),
                  (f"b{TRAIN_BATCH}_cut{CUT}", TRAIN_BATCH, CUT),
                  (f"b{MD_RANK_BATCH}_cut{CUT}_dp_rank", MD_RANK_BATCH, CUT)]
# the backward kernel (ops/sinc_fused.py:sinc_abs_pool_bwd): name, B, T, C, K; each
# at both precisions, d filters within K3_BWD_TOL * max of the plain version's once
# the near-tie triples (sinc_fused.near_tie_mask) are zeroed on both sides
K3_BWD_CASES = [("jax_case", 2, 8000, SINC_C, SINC_K), ("ragged", 3, 8001, SINC_C, SINC_K),
                (f"b{TRAIN_BATCH}_cut{CUT}", TRAIN_BATCH, CUT, SINC_C, SINC_K),
                (f"b{MD_RANK_BATCH}_cut{CUT}_dp_rank", MD_RANK_BATCH, CUT, SINC_C, SINC_K),
                ("c256_k129", 3, 5000, 256, 129), ("c16_k7", 3, 5000, 16, 7),
                ("ties", 2, 8000, SINC_C, SINC_K)]
K3_BWD_TOL = {"tf32": 2e-3, "3xtf32": 1e-4}
# K6 at the WavLM cell's shape: name, B, heads, T' (30 s at 16 kHz)
K6_CASES = [("cell_b16_t1499", 16, 16, 1499)]
K6_LAYERS = 24                    # WavLM-Large's transformer layers: K6 launches a forward
# maze6 on WavLM-Large as benchmark/configs/maze6_wavlm.json builds it, at its cell's cut
# (30 s at 16 kHz); the two ranks' time limit
WAVLM_OVERRIDES = {"model.wav2vec2.model_name": "microsoft/wavlm-large"}
WAVLM_CUT = 480000
WAVLM_LIMIT = 600.0
K5_CASES = [(f"b{EVAL_BATCH}_cut{CUT}", EVAL_BATCH, CUT),   # name, B, T
            (f"b{BENCH_BATCH}_cut{CUT}", BENCH_BATCH, CUT)]
K3_BWD_PASSES = {"tf32": 1, "3xtf32": 3}
# the least share of K5's outputs equal bit for bit to the composition's on
# random audio (the H100 reads 0.9997; operands rounded to bf16 read 0.631)
K5_EQUAL_SHARE_FLOOR = 0.99
PEAK_TF32_FLOPS = 495e12          # H100 SXM data sheet, dense TF32
# models trained through cli.train: (model, evaluate flags, K1 and K3 launches
# per batch evaluating the checkpoint), as MAIN_PATHS gives them
TRAIN_MODELS = ["maze5", "maze5_fmsl", "main", "main_fmsl", "lcnn_lfcc", "lcnn1d_lfcc",
                "resnet18_logmel"]
# the model extras of RawNet's fused training front end (K3 and its backward kernel)
K3_TRAIN = {"fused_train_frontend": True}
# adfmsl's own bounds for the fused training front end against the
# composition (tests/test_models.py:327-337)
FUSED_TRAIN_LOSS_REL, FUSED_TRAIN_GRAD_COS = 5e-2, 0.85
# (model, extra CLI flags, K1, K3, K4 and K5 launches per batch); the LFCC /
# log-mel models' front end is the composition (ops/lfcc.py), as in adfmsl;
# maze5's eval front end is K5 (a bf16 model, cuDNN's TF32 on)
MAIN_PATHS = [("maze5", [], 5, 0, 0, 1), ("maze5_fmsl", [], 5, 0, 0, 1),
              ("main", ["--fused_frontend"], 6, 1, 0, 0),
              ("main_fmsl", ["--fused_frontend"], 6, 1, 0, 0),
              ("lcnn_lfcc", [], 0, 0, 0, 0), ("lcnn1d_lfcc", [], 0, 0, 0, 0),
              ("resnet18_logmel", [], 0, 0, 0, 0)]
# the Wav2Vec2 models' main path (the same fields): K1 on their trunks, maze2's
# and maze6's wide stack heads included
W2V2_PATHS = [("maze7", [], 5, 0, 0, 0), ("maze7_fmsl", [], 5, 0, 0, 0),
              ("maze3", [], 3, 0, 0, 0), ("maze2", [], 6, 0, 0, 0),
              ("maze2_fmsl", [], 3, 0, 0, 0), ("maze3_fmsl", [], 3, 0, 0, 0),
              ("maze6", [], 5, 0, 0, 0), ("maze6_fmsl", [], 3, 0, 0, 0),
              ("maze8", [], 5, 0, 0, 0), ("maze8_fmsl", [], 5, 0, 0, 0)]
# trained through cli.train: maze7 (frozen encoder), maze2 (frozen, SpecAugment,
# the transformer), maze6_fmsl (the large encoder in autograd with its last two
# layers trained, ASP, the plateau scheduler)
W2V2_TRAIN = ("maze7", "maze2", "maze6_fmsl")
# activation checkpointing (phase remat): (model, batch, model extras, True for
# the Wav2Vec2 encoder's remat_layers / remat_extractor, else train.remat);
# maze6's config trains the large encoder's last two layers (freeze off)
REMAT_CASES = [("maze5", TRAIN_BATCH, {}, False), ("main", TRAIN_BATCH, K3_TRAIN, False),
               ("maze6", 4, {}, True)]
# the few-shot CLI (phase fewshot): its train fixture (spoofs A02 / A04 / A06,
# at least 10 a class for 5-shot 5-query episodes), the wild adapt fixture, the
# meta steps, the CLI's default shape (2-way, 5-shot, 5 queries, 4 episodes)
# and scoring batch, and tests/test_pallas.py's bf16 tolerance (x max(1, |s|))
FEWSHOT_TRAIN_UTTS, FEWSHOT_WILD_UTTS, FEWSHOT_STEPS = 64, 40, 3
FEWSHOT_K_SHOT, FEWSHOT_UTTS_A_STEP, FEWSHOT_SCORE_BATCH = 5, 80, 32
FEWSHOT_SCORE_TOL = 3e-2
# the config_cli phase: RawNet main's epochs from its YAML, and the __global__
# functions of K3 (csrc/sinc_abs_pool.cu:76) and K3-bwd (csrc/sinc_abs_pool_bwd.cu:134)
# its profiler trace must name
CONFIG_CLI_EPOCHS = 2
CONFIG_CLI_TRACE_KERNELS = ("sinc_abs_pool_kernel", "sinc_bwd_kernel")
K1_MAZE5 = 5                     # K1 launches a maze5 eval forward
# the loader's host rate: utterances of LOADER_SECONDS, decoded and padded a
# batch of BENCH_BATCH at a time, at each count of native threads
LOADER_UTTS, LOADER_SECONDS, LOADER_WORKERS, LOADER_PASSES = 256, 4, (1, 2, 4, 8), 3
# K4 (fused LFCC) at the model's front-end widths (FrontendConfig's defaults)
SR, N_FFT, HOP, WIN, N_FILTER, N_LFCC = 16000, 512, 160, 400, 70, 60
N_BINS = N_FFT // 2 + 1
K4_CASES = [(f"{name}_{p}", b, t, p)       # name, B, T, precision tier
            for name, b, t in (("jax_case", 2, 16000), ("ragged_404_frames", 1, CUT))
            for p in ("high", "default", "highest")
            ] + [(f"b{b}_cut{CUT}_high", b, CUT, "high") for b in (BENCH_BATCH, 384)
                 ] + [(f"b{BENCH_BATCH}_cut{CUT}_default", BENCH_BATCH, CUT, "default")]
K4_TC_PASSES = {"high": 3, "default": 1, "highest": 0}    # bf16 DFT passes per tier
# lcnn1d_lfcc's forward (phase 4b) takes a few ms and the shared host's
# launches set much of its pace, which drifts between and within runs: its
# utt/s is the median of several windows of a few seconds each, taken in turns
# (K4_FRONTEND_TURNS) and reported with its spread
SPECTRAL_WINDOW_S = 3.0
K4_FRONTEND_TURNS = ("composition", "k4", "k4", "composition") * 2
# the multidevice phase: its train steps, the tensor-parallel forward's batch,
# the bounds of its f32 steps against one process ((c) and (d)'s f32 witness),
# of its bf16 fused step (d) and of its two-rank scores (b), the limit of each
# of its launches in seconds, and the note its two-rank times carry
MD_STEPS, MD_TP_BATCH = 3, 8
MD_LOSS_REL, MD_GRAD_COS, MD_UPDATE_COS = 1e-4, 0.9999, 0.999
# (d) in bf16 read loss 6.3e-3 apart and gradient cosine 0.970 on the card in
# two runs, while the one-process bf16 gradient sits at 0.950 from the
# one-process f32 one; a rank that kept its own gradient (the all-reduce
# dropped) reads far below either bound
MD_BF16_LOSS_REL, MD_BF16_GRAD_COS = 1e-2, 0.95
MD_SCORE_REL = 1e-5
MD_LIMIT = 300.0
MD_SHARED = "two ranks share one card; gloo stages through the host"
# the reference_ckpt phase: its fixture, the thesis-style checkpoints it
# converts (main's RawNet with the original RawNet2 yaml's 3 GRU layers) and
# the score bound adfmsl promises for them (tests/test_port.py:961,
# adfmsl/cli/evaluate.py:101-104)
REF_TRAIN_UTTS, REF_DEV_UTTS, REF_EVAL_UTTS = 24, 12, 16
REF_CKPT_MODELS = ("maze5", "maze5_fmsl", "maze4_fmsl", "main")
REF_GRU_LAYERS = 3
REF_SCORE_ATOL, REF_SCORE_RTOL = 5e-4, 1e-3
# the packs phase: the augmentation's banks (fixture clips, synthetic RIRs and
# their length), the train protocol's head for the two-rank run (2 steps of
# TRAIN_BATCH), and the limit of each cli.pack call in seconds
PACK_NOISE_CLIPS, PACK_RIRS, PACK_RIR_LEN = 8, 4, 2048
PACK_MD_UTTS = 2 * TRAIN_BATCH
PACK_LIMIT = 300.0
# the analysis phase: its eval fixture (two batches of BENCH_BATCH), the
# bootstrap's resamples and the LA eval list's size and bonafide count, and
# BNAct's case (maze5 block0 at batch 16) with its bf16 tolerance (x max(1, |ref|))
ANALYSIS_UTTS = 2 * BENCH_BATCH
BOOT_UTTS, BOOT_BONAFIDE, BOOT_RESAMPLES = 71237, 7355, 1000
BNACT_SHAPE, BNACT_TOL = (16, 21450, 128), 2e-2


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


def k5_bound(b, t, c, k):
    """(ops_ms, bytes_ms): the correlation's 2*B*T'*C*K products at the TF32
    tensor-core peak, and x and the filters read once and the bf16 output
    written once at the HBM rate. The bound is the larger of the two."""
    t_out = t - k + 1
    flops = 2.0 * b * t_out * c * k
    nbytes = 4 * b * t + 4 * c * k + 2 * b * t_out * c
    return flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def k5_launches():
    """K5's calls so far (the always-on ``sinc.fused_bn_act`` counter)."""
    from adfmsl_torch.utils.profiling import totals

    return totals().get("sinc.fused_bn_act", 0)


def k5_case(filters, name, b, t, seed, dev):
    """K5 against the composition (its plain version) under cuDNN's TF32: one
    count a call, within ``composition_gap``'s bound and at least
    ``K5_EQUAL_SHARE_FLOOR`` of the outputs bit for bit; both times beside the
    bound."""
    from adfmsl_torch.ops import sinc_bn_act as k5

    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.1 * torch.randn((b, t), generator=g, device=dev)
    c = filters.shape[0]
    scale = float(F.conv1d(x[:1, None], filters[:, None]).std())
    bn = (0.1 * scale * torch.randn(c, generator=g, device=dev),
          (1 + torch.rand(c, generator=g, device=dev)) / scale,
          0.5 * torch.randn(c, generator=g, device=dev))
    before = k5_launches()
    out = k5.sinc_bn_act_fused(x, filters, *bn)
    torch.cuda.synchronize()
    counted = k5_launches() - before
    gap = k5.composition_gap(out, x, filters, *bn)
    del out
    ms = cuda_ms(lambda: k5.sinc_bn_act_fused(x, filters, *bn))
    composition_ms = cuda_ms(lambda: k5.sinc_bn_act_plain(x, filters, *bn))
    ops_ms, bytes_ms = k5_bound(b, t, *filters.shape)
    rec = {"case": name, "B": b, "T": t, "C": c, "K": filters.shape[1], **gap,
           "counted": counted, "kernel_ms": ms, "plain_ms": composition_ms, "composition_ms": composition_ms,
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print("K5 " + json.dumps(rec), flush=True)
    check(counted == 1, f"K5 {name}: one call counted {counted} times")
    check(gap["max_gap_over_bound"] <= 1.0, f"K5 {name}: gap over bound {gap}")
    check(gap["equal_share"] >= K5_EQUAL_SHARE_FLOOR,
          f"K5 {name}: {gap['equal_share']} of the outputs bit for bit, under "
          f"{K5_EQUAL_SHARE_FLOOR}")
    del x
    torch.cuda.empty_cache()
    return rec


def k6_case(name, b, heads, t, seed, dev):
    """K6 against its plain version: one count a call, within
    ``composition_gap``'s bound, each side's gap to the exact attention; the
    kernel's, the plain version's and the composition's times (the last with
    the bias table built beforehand, as the model built it once a forward)
    beside the bound of one layer."""
    from adfmsl_torch.ops import wavlm_attention as k6

    sys.path.insert(0, str(ROOT / "benchmark"))
    from benchlib.attention_roofline import attention_bound_ms

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (s * torch.randn(b, t, heads * k6.HEAD_DIM, generator=g, device=dev)
               .bfloat16() for s in (2.0, 0.25, 1.0))
    gate = 1 + torch.rand(b, heads, t, generator=g, device=dev)
    row = torch.randn(heads, 2 * t - 1, generator=g, device=dev)
    before = k6.wavlm_attention.launches
    out = k6.wavlm_attention(q, k, v, gate, row)
    torch.cuda.synchronize()
    counted = k6.wavlm_attention.launches - before
    gap = k6.composition_gap(out, q, k, v, gate, row)
    del out
    bias = k6.bias_from_row(row, t)
    qs = k6.scale_query(q, k6.HEAD_DIM)
    ms = cuda_ms(lambda: k6.wavlm_attention(q, k, v, gate, row))
    plain_ms = cuda_ms(lambda: k6.wavlm_attention_plain(q, k, v, gate, row), reps=2)
    composition_ms = cuda_ms(lambda: k6.attention_composition(qs, k, v, gate, bias), reps=2)
    bound = attention_bound_ms(b, t, heads, k6.HEAD_DIM, 1)
    flops = 4.0 * b * heads * t * t * k6.HEAD_DIM
    rec = {"case": name, "B": b, "heads": heads, "T": t, **gap, "counted": counted,
           "kernel_ms": ms, "plain_ms": plain_ms, "composition_ms": composition_ms,
           "ops_ms": flops / PEAK_BF16_FLOPS * 1e3,
           "bytes_ms": 8.0 * b * t * heads * k6.HEAD_DIM / PEAK_BYTES * 1e3,
           "bound_ms": bound, "roofline_pct": 100 * bound / ms,
           "tflop_per_s": flops / ms / 1e9}
    print("K6 " + json.dumps(rec), flush=True)
    check(counted == 1, f"K6 {name}: one call counted {counted} times")
    check(gap["max_gap_over_bound"] <= 1.0, f"K6 {name}: gap over bound {gap}")
    del q, qs, k, v, gate, row, bias
    torch.cuda.empty_cache()
    return rec


def phase_kernels(rf, sf, lf, dev):
    """K1, K3 and K4 against their plain versions, TF32 off so those are f32
    (K4's plain version rounds its operands to bf16 itself at 'high' and
    'default', where TF32 products are exact); then K3's backward kernel at
    both precisions (``k3_bwd_case``) and K5 under cuDNN's TF32 (``k5_case``)."""
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
    filters = sinc_filters_at_init(dev)
    k5 = [k5_case(filters, *c, seed=50 + i, dev=dev) for i, c in enumerate(K5_CASES)]
    k6 = [k6_case(*c, seed=60 + i, dev=dev) for i, c in enumerate(K6_CASES)]
    figs = {**build_report("sinc_abs_pool", "sinc_abs_pool_kernel"),
            **build_report("sinc_abs_pool_bwd", "sinc_bwd_kernel"),
            **build_report("sinc_bn_act", "sinc_bn_act_kernel"),
            **build_report("wavlm_attention", "wavlm_attention_kernel")}
    return k1, k3, k3b, k4, k5, k6, figs


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


def phase_main_path(name, flags, k1_per_batch, k3_per_batch, k4_per_batch, k5_per_batch,
                    rf, sf, lf, fixture, tmp):
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
    k5_before = k5_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_launches = rf.resblock_eval.launches
    k3_launches = sf.sinc_abs_pool_fused.launches
    k4_launches = lf.lfcc_fused.launches
    k5 = k5_launches() - k5_before
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
    check(k5 == k5_per_batch * n_batches,
          f"{name}: K5 launched {k5} times, expected {k5_per_batch * n_batches}")
    rec = {"model": name, "flags": flags, "utterances": len(ids), "batch": EVAL_BATCH,
           "batches": n_batches, "k1_launches": k1_launches,
           "k3_launches": k3_launches, "k4_launches": k4_launches, "k5_launches": k5,
           "eer": metrics[-1]["eer"], "wall_s": wall_s}
    print("main_path " + json.dumps(rec), flush=True)
    return rec


def phase_wavlm_main_path(fixture, tmp, dev):
    """maze6 on WavLM-Large through the evaluate CLI on two ranks, then in
    training (phase 4d); returns the record."""
    from adfmsl_torch.config import apply_overrides, make_experiment
    from adfmsl_torch.models import build_model, save_checkpoint
    from adfmsl_torch.parallel import kernel_launches, reset_kernel_launches
    from adfmsl_torch.utils.profiling import totals

    exp = make_experiment("maze6")
    apply_overrides(exp, WAVLM_OVERRIDES)
    exp.data.cut = WAVLM_CUT
    model = build_model(exp.model, device=dev, seed=0)
    ck = os.path.join(tmp, "maze6_wavlm_ck")
    save_checkpoint(ck, exp, model)
    ev = fixture["eval"]
    out = os.path.join(tmp, "maze6_wavlm_scores.txt")
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "adfmsl_torch.cli.evaluate",
                          "--model_type", "maze6", "--model_path", ck,
                          "--protocol", ev["protocol"], "--data_dir", ev["audio_dir"],
                          "--output", out, "--batch_size", str(EVAL_BATCH),
                          "--cut", str(WAVLM_CUT), "--device", "cuda",
                          "--data_parallel", "2", "--dist_backend", "gloo",
                          "--dist_timeout", str(WAVLM_LIMIT)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         cwd=str(ROOT), start_new_session=True)
    try:
        stdout, stderr = p.communicate(timeout=WAVLM_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)      # the CLI and the ranks it spawned
        p.communicate()
        raise
    wall_s = time.perf_counter() - t0
    check(p.returncode == 0, f"wavlm: evaluate exited {p.returncode}: {stderr[-3000:]}")
    ranks = []
    for ln in stdout.splitlines():
        if ln.startswith("rank_summary "):
            print(ln, flush=True)
            ranks.append(json.loads(ln.split(" ", 1)[1]))
    with open(out) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()]
    check([ln[0] for ln in lines] == ev["utt_ids"],
          "wavlm: score file ids differ from the protocol")
    check(bool(np.isfinite([float(ln[1]) for ln in lines]).all()), "wavlm: non-finite scores")
    # each rank scores its row block of every batch: one forward a batch
    want = K6_LAYERS * -(-EVAL_UTTS // EVAL_BATCH)
    counts = [{"K6": r["kernel_launches"]["K6"],
               **{c: r["counters"].get(c, 0) for c in ("w2v2.fused_attention",
                                                       "w2v2.gated_layers")}}
              for r in ranks]
    check(len(ranks) == 2 and all(set(c.values()) == {want} for c in counts),
          f"wavlm: rank counts {counts}, expected {want} each")

    model.train()
    reset_kernel_launches()
    before = totals().get("w2v2.fused_attention", 0)
    x = 0.1 * torch.randn(2, 32000, generator=torch.Generator().manual_seed(0)).to(dev)
    model(x, rngs={n: torch.Generator(device=dev).manual_seed(i)
                   for i, n in enumerate(("dropout", "specaugment", "lsa"))})
    torch.cuda.synchronize()
    train = {"K6": kernel_launches()["K6"],
             "w2v2.fused_attention": totals().get("w2v2.fused_attention", 0) - before}
    check(train == {"K6": 0, "w2v2.fused_attention": 0}, f"wavlm: training counted {train}")
    rec = {"model": "maze6", "overrides": WAVLM_OVERRIDES, "cut": WAVLM_CUT,
           "batch": EVAL_BATCH, "utterances": len(lines), "ranks": counts,
           "expected_each": want, "train_forward": train, "wall_s": wall_s}
    print("wavlm_main_path " + json.dumps(rec), flush=True)
    del model, x
    torch.cuda.empty_cache()
    return rec


def phase_native_io(rf, fixture, tmp):
    """The fixture's eval split as FLAC (FIXED subframes) against its WAV
    twin through maze5's evaluate CLI (identical score files, K1 5 times and
    K5 once a batch), then the loader's host rate (``LOADER_*``); returns the record."""
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.data import AsvspoofDataset, parse_protocol
    from adfmsl_torch.data.flac import flac_twin
    from adfmsl_torch.ops import _build

    ev = fixture["eval"]
    flac_dir = os.path.join(tmp, "eval_flac")
    rec = {"decoder": str(_build.library_path("adfmsl_torch_io").relative_to(ROOT)),
           "flac_files": flac_twin(ev["audio_dir"], flac_dir)}
    n_batches = -(-EVAL_UTTS // EVAL_BATCH)
    scores = {}
    for fmt, d in (("wav", ev["audio_dir"]), ("flac", flac_dir)):
        out = os.path.join(tmp, f"maze5_{fmt}_scores.txt")
        rf.resblock_eval.launches = 0
        k5_before = k5_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = evaluate.main(["--model_type", "maze5", "--protocol", ev["protocol"],
                                "--data_dir", d, "--output", out, "--batch_size",
                                str(EVAL_BATCH), "--cut", str(CUT), "--device", "cuda",
                                "--seed", "0"])
        torch.cuda.synchronize()
        k5 = k5_launches() - k5_before
        check(rc == 0, f"maze5 over the {fmt} eval split: evaluate exited {rc}")
        check(rf.resblock_eval.launches == 5 * n_batches,
              f"maze5 over {fmt}: K1 launched {rf.resblock_eval.launches} times")
        check(k5 == n_batches, f"maze5 over {fmt}: K5 launched {k5} times")
        rec[f"k5_launches_{fmt}"] = k5
        with open(out, "rb") as fh:
            scores[fmt] = fh.read()
    check(scores["wav"] == scores["flac"],
          "maze5: the FLAC eval split's score file differs from its WAV twin's")
    rec["score_files_identical"] = True

    # the loader's host rate: 4 s utterances, a tone and noise, as FLAC and WAV
    proto_path, ids, dirs = loader_corpus(tmp)
    proto = parse_protocol(proto_path)
    configs = ([(f"flac_native_w{w}", "flac", True, w) for w in LOADER_WORKERS]
               + [("wav_native_w8", "wav", True, 8), ("wav_numpy", "wav", False, 1)])
    rates = {key: loader_rate(AsvspoofDataset(proto, dirs[fmt], cut=CUT,
                                              use_native_io=native, num_workers=workers),
                              ids, key)
             for key, fmt, native, workers in configs}
    rec.update(utterances=LOADER_UTTS, seconds_each=LOADER_SECONDS, batch=BENCH_BATCH,
               cpu_count=os.cpu_count(), loader=rates)
    print("native_io " + json.dumps(rec), flush=True)
    return rec


def loader_corpus(tmp):
    """The loader's host-rate corpus under ``tmp``, written at the first call:
    ``LOADER_UTTS`` utterances of ``LOADER_SECONDS`` s, a tone and noise, as
    FLAC (FIXED subframes) and as 16-bit WAV; returns (protocol path, ids,
    {format: dir})."""
    from adfmsl_torch.data import write_wav
    from adfmsl_torch.data.flac import write_flac

    dirs = {fmt: os.path.join(tmp, f"loader_{fmt}") for fmt in ("flac", "wav")}
    ids = [f"LA_L_{i:05d}" for i in range(LOADER_UTTS)]
    proto_path = os.path.join(tmp, "loader_protocol.txt")
    if os.path.exists(proto_path):
        return proto_path, ids, dirs
    rng = np.random.default_rng(6)
    n = 16000 * LOADER_SECONDS
    for d in dirs.values():
        os.makedirs(d)
    for i, u in enumerate(ids):
        x = 0.3 * np.sin(2 * np.pi * (150 + i) * np.arange(n) / 16000)
        x = np.clip(x + 0.05 * rng.standard_normal(n), -1.0, 1.0).astype(np.float32)
        write_flac(os.path.join(dirs["flac"], u + ".flac"), np.round(x * 32767.0))
        write_wav(os.path.join(dirs["wav"], u + ".wav"), x, 16000)
    with open(proto_path, "w") as fh:
        fh.write("".join(f"LA_0000 {u} - - bonafide\n" for u in ids))
    return proto_path, ids, dirs


def loader_rate(ds, ids, key):
    """Host utt/s of ``ds.load_batch`` over ``ids`` a batch of ``BENCH_BATCH``
    at a time: the median of ``LOADER_PASSES`` passes over files (or a pack)
    in the page cache."""
    ds.load_batch(ids[:8])                            # page cache, first call
    secs = []
    for _ in range(LOADER_PASSES):
        t0 = time.perf_counter()
        for b in range(0, len(ids), BENCH_BATCH):
            audio, _ = ds.load_batch(ids[b:b + BENCH_BATCH])
        secs.append(time.perf_counter() - t0)
    check(audio.shape == (BENCH_BATCH, CUT) and bool(audio.any()),
          f"loader {key}: batch {audio.shape}")
    return {"utt_per_s": len(ids) / float(np.median(secs)), "passes_s": secs}


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


def phase_folded_vs_unfolded(rf, sf, dev):
    """Untimed: the folded (K1) bf16 trunk against the unfolded one on 4 clips
    for maze5, maze5_fmsl and the ``W2V2_K1_BLOCKS`` models, K1 launched a
    forward as the model's path says and not at all unfolded; then main's K3
    front end against the composition at batch ``EVAL_BATCH`` and main's
    composition front end at batch ``BENCH_BATCH`` (adfmsl's dispatch there),
    both with the K1 trunk. Logits within 3e-2 * max(1, |logits|). Returns the
    records."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    def built(name, **extra):
        exp = make_experiment(name)
        exp.model.extra.update(extra)
        return build_model(exp.model, device=dev, seed=0)

    def run(model, x):
        rf.resblock_eval.launches = 0
        sf.sinc_abs_pool_fused.launches = 0
        with torch.inference_mode():
            out = model(x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out["scores"]).all()), "non-finite scores")
        return out["logits"].float(), rf.resblock_eval.launches, sf.sinc_abs_pool_fused.launches

    def held(name, key, got, want):
        err = (got - want).abs().max().item()
        tol = 3e-2 * max(1.0, want.abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"{name}: {key} logits differ by {err} > {tol}")
        return {f"logits_{key}_max_abs_err": err, "tol": tol}

    g = torch.Generator(device=dev).manual_seed(1)
    x = 0.1 * torch.randn((BENCH_BATCH, CUT), generator=g, device=dev)
    recs = []
    for name in ("maze5", "maze5_fmsl", *(m for m, _ in W2V2_K1_BLOCKS)):
        folded = built(name, fused_eval_trunk=True)
        unfolded = built(name, fused_eval_trunk=False)
        unfolded.load_state_dict(folded.state_dict())
        lf, k1, _ = run(folded, x[:4])
        lu, k1_unfolded, _ = run(unfolded, x[:4])
        want = next(p[2] for p in MAIN_PATHS + W2V2_PATHS if p[0] == name)
        check(k1 == want and k1_unfolded == 0,
              f"{name}: K1 launched {k1} times folded, {k1_unfolded} unfolded, "
              f"expected {want} and 0")
        recs.append({"model": name, "clips": 4, "cut": CUT, "k1_launches": k1,
                     **held(name, "folded_vs_unfolded", lf, lu)})
        del folded, unfolded
    k3_front = built("main", fused_eval_trunk=True, fused_eval_frontend=True)
    composition = built("main", fused_eval_trunk=True, fused_eval_frontend=False)
    lk, k1, k3 = run(k3_front, x[:EVAL_BATCH])
    lc, _, k3_composition = run(composition, x[:EVAL_BATCH])
    check(k1 == 6 and k3 == 1 and k3_composition == 0,
          f"main: K1 {k1} and K3 {k3} / {k3_composition} launches at batch {EVAL_BATCH}")
    _, k1, k3 = run(composition, x)
    check(k1 == 6 and k3 == 0, f"main: K1 {k1} and K3 {k3} launches at batch {BENCH_BATCH}")
    recs.append({"model": "main", "batch": EVAL_BATCH, "cut": CUT,
                 **held("main", f"k3_vs_composition_b{EVAL_BATCH}", lk, lc),
                 f"composition_b{BENCH_BATCH}_finite": True})
    for rec in recs:
        print("folded_vs_unfolded " + json.dumps(rec), flush=True)
    del k3_front, composition, x
    torch.cuda.empty_cache()
    return recs


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
    init_model = build_model(exp.model, device="cpu", seed=exp.train.seed)
    init = init_model.state_dict()
    # the optimizer's 'frozen' parameters (a frozen Wav2Vec2 encoder; maze6's
    # encoder outside its last two layers) stay as initialised; everything
    # else moves
    from adfmsl_torch.train import param_labels

    labels = param_labels(exp.model.wav2vec2, init_model)
    frozen = {k for k, lb in labels.items() if lb == "frozen"}
    # the FMSL 'replace' loss (the CE of the head's logits) reaches neither the
    # prototypes nor the temperature: only AdamW's decoupled decay moves them,
    # by a factor 1 - lr * wd that rounds to 1 in f32 below 2^-24 (maze6_fmsl:
    # lr 1e-5, wd 1e-4)
    opt = exp.train.optimizer
    idle = set()
    if (exp.model.fmsl is not None and exp.model.fmsl.mode == "replace"
            and opt.name == "adamw" and opt.lr * opt.weight_decay < 2.0 ** -24):
        idle = {"fmsl.prototypes", "fmsl.temperature"}
    for a, b, what in ((init, models[0], "epoch 0"), (models[0], models[1], "epoch 1")):
        wrong = [k for k, v in b.items() if not k.endswith("num_batches_tracked")
                 and torch.equal(v, a[k]) != (k in frozen | idle)]
        check(not wrong, f"{name}: moved or unmoved against its labels by {what}: "
                         f"{wrong[:8]}")
    trained_layers = sorted({int(k.split(".")[1][len("layers_"):]) for k in labels
                             if k.startswith("wav2vec2.layers_") and k not in frozen})
    if exp.model.wav2vec2.unfreeze_last_n:
        n_layers = sum(1 for k in labels if k.startswith("wav2vec2.layers_")
                       and k.endswith("final_layer_norm.weight"))
        check(trained_layers == list(range(n_layers - exp.model.wav2vec2.unfreeze_last_n,
                                           n_layers)),
              f"{name}: encoder layers {trained_layers} trained")

    ev = fixture["eval"]
    out = os.path.join(tmp, f"{name}_trained_scores.txt")
    _, flags, k1_per_batch, k3_per_batch, _, k5_per_batch = next(
        p for p in MAIN_PATHS + W2V2_PATHS if p[0] == name)
    rf.resblock_eval.launches = 0
    sf.sinc_abs_pool_fused.launches = 0
    k5_before = k5_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(["--model_type", name, "--model_path", ck, "--protocol",
                            ev["protocol"], "--data_dir", ev["audio_dir"], "--output", out,
                            "--batch_size", str(EVAL_BATCH), "--device", dev.type, *flags])
    torch.cuda.synchronize()
    k1_eval, k3_eval = rf.resblock_eval.launches, sf.sinc_abs_pool_fused.launches
    k5_eval = k5_launches() - k5_before
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
    check(k5_eval == k5_per_batch * n_batches,
          f"{name}: K5 launched {k5_eval} times evaluating the checkpoint, expected "
          f"{k5_per_batch * n_batches}")
    rec = {"model": name, "cut": CUT, "batch": TRAIN_BATCH, "train_utts": TRAIN_UTTS,
           "dev_utts": DEV_UTTS, "epochs": hist, "steps": 2 * steps_per_epoch,
           "retained_epochs": mgr.all_epochs(), "k1_launches_training": k1_train,
           "k2_launches_training": k2_train, "k3_launches_training": k3_train,
           "evaluate_flags": flags, "k1_launches_evaluate": k1_eval,
           "k3_launches_evaluate": k3_eval, "k5_launches_evaluate": k5_eval,
           "frozen_parameters": len(frozen),
           "idle_parameters": sorted(idle),
           "trained_encoder_layers": trained_layers, "wall_s": wall_s}
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


def _step_record(st, gens, met, dev):
    """What one train step left behind: its loss, unclipped gradients, BN
    buffers and the states of its generators (on the host)."""
    return {"loss": float(met["loss"]), "grads": _grads(st, met),
            "buffers": {k: v.detach().float().cpu() for k, v in st.model.named_buffers()},
            "generators": {k: g.get_state() for k, g in gens.items()}}


def _compare_steps(name, a, b):
    """Remat step ``b`` against the plain step ``a`` from the same weights and
    generators: the generators' states equal, BN buffers within 1e-3 *
    max(1, |v|) (the same forward ran once; cuDNN may pick other kernels),
    loss within 1e-3 relative, per-leaf gradient cosine as in
    tests/test_torch_train_step.py (0.999, 0.99 under 512 elements; leaves
    under 3e-5 of the global norm on both sides skipped)."""
    for k in a["generators"]:
        check(torch.equal(a["generators"][k], b["generators"][k]),
              f"remat ({name}): generator '{k}' ends elsewhere than the plain step's")
    buf_err = 0.0
    for k, v in a["buffers"].items():
        err = float((v - b["buffers"][k]).abs().max()) / max(1.0, float(v.abs().max()))
        buf_err = max(buf_err, err)
    gnorm = math.sqrt(sum(float(v @ v) for v in a["grads"].values()))
    worst, checked = 1.0, 0
    for k, g in a["grads"].items():
        h = b["grads"][k]
        na, nb = float(np.linalg.norm(g)), float(np.linalg.norm(h))
        if na < 3e-5 * gnorm and nb < 3e-5 * gnorm:
            continue
        cos = float(g @ h) / (na * nb)
        check(cos >= (0.999 if g.size >= 512 else 0.99),
              f"remat ({name}): {k} gradient cosine {cos}")
        worst, checked = min(worst, cos), checked + 1
    rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    check(rel <= 1e-3 and buf_err <= 1e-3 and checked >= 20,
          f"remat ({name}): loss {rel}, buffers {buf_err}, {checked} leaves")
    return {"loss_plain": a["loss"], "loss_remat": b["loss"], "loss_rel_diff": rel,
            "worst_grad_cosine": worst, "leaves_checked": checked,
            "bn_buffer_max_rel_diff": buf_err, "generators_equal": True}


class _LogLines(logging.Handler):
    """Collects the messages of the root logger at INFO and above."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def root_log_lines():
    """The root logger's INFO messages while the block runs (the CLIs log
    through it; its level is restored after)."""
    root, handler = logging.getLogger(), _LogLines()
    level = root.level
    root.setLevel(logging.INFO)
    root.addHandler(handler)
    try:
        yield handler.messages
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def timer_rows(messages):
    """{phase: {"total_s", "count", "mean_ms"}} of the last step-timer report
    among ``messages``."""
    report = [m for m in messages if m.startswith("step timing:")][-1]
    return {name: {"total_s": float(total), "count": int(count), "mean_ms": float(mean)}
            for name, total, count, mean in (ln.split() for ln in report.splitlines()[2:])}


def phase_config_cli(rf, sf, fixture, tmp, card):
    """The train CLI driven by config files (``config_cli``). (a) RawNet main
    from a YAML the port's ``save_yaml`` wrote, with ``fused_train_frontend``
    in ``model.extra``, trained 2 epochs at batch 12 with ``--log_dir`` and
    ``--profile_dir``: K3 and its backward kernel once a step; the
    checkpoints' ``experiment.yaml`` is the tree the run used; the metrics log
    holds ``train/loss``, ``train/acc`` and ``dev/acc`` at steps 0 and 1,
    finite and equal to each epoch's checkpoint metrics; one trace, naming
    both kernels; the step timer's report counts every step. (b) maze5 from
    ``configs/maze5.yaml`` for one epoch, then ``--eval --restore`` from a
    copy with ``fused_eval_trunk``: K1 5 a batch, ``experiment.yaml`` not
    overwritten, the score file against ``cli.evaluate --model_path`` at the
    same batch within 3e-2 * max(1, |score|)."""
    import dataclasses

    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.config import load_yaml, make_experiment, save_yaml
    from adfmsl_torch.models import load_checkpoint
    from adfmsl_torch.train import CheckpointManager
    from adfmsl_torch.utils import read_metrics

    root = os.path.join(tmp, "config_cli")
    os.makedirs(root)
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]
    data = ["--train_protocol", tr["protocol"], "--train_dir", tr["audio_dir"]]
    steps = TRAIN_UTTS // TRAIN_BATCH

    # (a)
    exp = make_experiment("main")
    exp.train.batch_size, exp.train.num_epochs = TRAIN_BATCH, CONFIG_CLI_EPOCHS
    exp.train.keep_best_k = CONFIG_CLI_EPOCHS        # both epochs' metrics stay
    exp.model.extra.update(K3_TRAIN)
    cfg = os.path.join(root, "main_k3.yaml")
    save_yaml(exp, cfg)
    ck, logs, prof = (os.path.join(root, d) for d in ("main_ck", "logs", "profile"))
    sf.sinc_abs_pool_fused.launches = sf.sinc_abs_pool_bwd.launches = 0
    t0 = time.perf_counter()
    with root_log_lines() as messages:
        rc = cli_train.main(["--config", cfg, *data, "--dev_protocol", dv["protocol"],
                             "--dev_dir", dv["audio_dir"], "--checkpoint_dir", ck,
                             "--log_dir", logs, "--profile_dir", prof, "--device", "cuda"])
        torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    k3, k3b = sf.sinc_abs_pool_fused.launches, sf.sinc_abs_pool_bwd.launches
    n_steps = CONFIG_CLI_EPOCHS * steps
    check(rc == 0, f"config_cli (a): cli.train exited {rc}")
    check(k3 == n_steps and k3b == n_steps,
          f"config_cli (a): K3 {k3} and K3-bwd {k3b} launches in {n_steps} steps")
    used = load_yaml(cfg)                 # the YAML after the CLI's path overrides
    used.data.database_path, used.data.protocols_path = "data/", "protocols/"
    saved = load_yaml(os.path.join(ck, "experiment.yaml"))
    check(dataclasses.asdict(saved) == dataclasses.asdict(used)
          == dataclasses.asdict(load_checkpoint(ck)[0]),
          "config_cli (a): experiment.yaml is not the tree the run used")
    mgr, logged = CheckpointManager(ck), read_metrics(logs)
    for tag, key in (("train/loss", "train_loss"), ("train/acc", "train_acc"),
                     ("dev/acc", "dev_acc")):
        want = [(e, mgr.metrics(e)[key]) for e in range(CONFIG_CLI_EPOCHS)]
        check(logged.get(tag) == want and all(math.isfinite(v) for _, v in want),
              f"config_cli (a): {tag} logged {logged.get(tag)}, checkpoints {want}")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    check(len(traces) == 1, f"config_cli (a): traces {traces}")
    with open(traces[0]) as fh:
        kernels = {e["name"] for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for fn in CONFIG_CLI_TRACE_KERNELS:
        check(any(fn in k for k in kernels), f"config_cli (a): no {fn} in the trace")
    rows = timer_rows(messages)
    # each epoch's last input wait finds the loader's end
    counts = {k: v["count"] for k, v in rows.items()}
    check(counts == {"input": n_steps + CONFIG_CLI_EPOCHS, "train_step": n_steps},
          f"config_cli (a): step timer {rows}")
    epochs = [mgr.metrics(e) for e in range(CONFIG_CLI_EPOCHS)]
    rec_a = {"model": "main", "extra": K3_TRAIN, "batch": TRAIN_BATCH, "cut": CUT,
             "steps": n_steps, "k3_launches": k3, "k3_bwd_launches": k3b,
             "epoch_seconds": [next(float(m.split("(")[-1].rstrip("s)")) for m in messages
                                    if m.startswith(f"epoch {e} done"))
                               for e in range(CONFIG_CLI_EPOCHS)],
             "epochs": epochs, "timer": rows, "trace_bytes": os.path.getsize(traces[0]),
             "trace_kernels": sorted(k for k in kernels
                                     if any(fn in k for fn in CONFIG_CLI_TRACE_KERNELS)),
             "wall_s": wall_a, "card": card}
    print("config_cli_a " + json.dumps(rec_a), flush=True)

    # (b)
    ck2 = os.path.join(root, "maze5_ck")
    maze5_yaml = str(ROOT / "configs" / "maze5.yaml")
    t0 = time.perf_counter()
    rc = cli_train.main(["--config", maze5_yaml, *data, "--num_epochs", "1",
                         "--protocols_path", os.path.join(root, "no_protocols"),
                         "--checkpoint_dir", ck2, "--device", "cuda"])
    torch.cuda.synchronize()
    check(rc == 0, f"config_cli (b): cli.train exited {rc}")
    with open(os.path.join(ck2, "experiment.yaml")) as fh:
        saved_text = fh.read()
    fused = load_yaml(maze5_yaml)
    fused.model.extra["fused_eval_trunk"] = True
    fused_cfg = os.path.join(root, "maze5_fused.yaml")
    save_yaml(fused, fused_cfg)
    outs = {k: os.path.join(root, f"maze5_{k}_scores.txt") for k in ("train_eval", "evaluate")}
    rf.resblock_eval.launches = 0
    k5_before = k5_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_train.main(["--config", fused_cfg, *data, "--eval", "--restore",
                             "--checkpoint_dir", ck2, "--eval_protocol", ev["protocol"],
                             "--eval_dir", ev["audio_dir"], "--eval_output",
                             outs["train_eval"], "--device", "cuda"])
    torch.cuda.synchronize()
    k1_train_eval = rf.resblock_eval.launches
    k5_train_eval = k5_launches() - k5_before
    check(rc == 0, f"config_cli (b): cli.train --eval exited {rc}")
    with open(os.path.join(ck2, "experiment.yaml")) as fh:
        check(fh.read() == saved_text, "config_cli (b): --eval overwrote experiment.yaml")
    batch = fused.train.eval_batch_size
    rf.resblock_eval.launches = 0
    k5_before = k5_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = evaluate.main(["--model_type", "maze5", "--model_path", ck2, "--protocol",
                            ev["protocol"], "--data_dir", ev["audio_dir"], "--output",
                            outs["evaluate"], "--batch_size", str(batch), "--device", "cuda"])
    torch.cuda.synchronize()
    k1_evaluate = rf.resblock_eval.launches
    k5_evaluate = k5_launches() - k5_before
    wall_b = time.perf_counter() - t0
    check(rc == 0, f"config_cli (b): evaluate exited {rc}")
    scores = {}
    for k, path in outs.items():
        with open(path) as fh:
            rows_k = [ln.split() for ln in fh.read().splitlines()]
        check([r[0] for r in rows_k] == ev["utt_ids"], f"config_cli (b): {k} score file ids")
        scores[k] = np.asarray([float(r[1]) for r in rows_k])
        check(bool(np.isfinite(scores[k]).all()), f"config_cli (b): {k} non-finite scores")
    n_batches = -(-EVAL_UTTS // batch)
    check(k1_train_eval == K1_MAZE5 * n_batches and k1_evaluate == K1_MAZE5 * n_batches,
          f"config_cli (b): K1 {k1_train_eval} (cli.train --eval) and {k1_evaluate} "
          f"(cli.evaluate) launches, expected {K1_MAZE5 * n_batches}")
    check(k5_train_eval == n_batches and k5_evaluate == n_batches,
          f"config_cli (b): K5 {k5_train_eval} (cli.train --eval) and {k5_evaluate} "
          f"(cli.evaluate) launches, expected {n_batches}")
    err = float(np.abs(scores["train_eval"] - scores["evaluate"]).max())
    tol = FEWSHOT_SCORE_TOL * max(1.0, float(np.abs(scores["evaluate"]).max()))
    rec_b = {"model": "maze5", "config": "configs/maze5.yaml",
             "train_steps": TRAIN_UTTS // fused.train.batch_size,
             "eval_batch": batch, "eval_batches": n_batches,
             "k1_launches_train_eval": k1_train_eval, "k1_launches_evaluate": k1_evaluate,
             "k5_launches_train_eval": k5_train_eval, "k5_launches_evaluate": k5_evaluate,
             "scores_max_abs_diff": err, "scores_tol": tol, "wall_s": wall_b, "card": card}
    print("config_cli_b " + json.dumps(rec_b), flush=True)
    check(err <= tol, f"config_cli (b): scores {err} apart, tolerance {tol}")
    return {"a": rec_a, "b": rec_b}


def pack_cli(argv, in_process=True):
    """The pack CLI on ``argv``: its ``main`` in this process, or ``python -m
    adfmsl_torch.cli.pack`` in a subprocess; returns its printed line and the
    utt/s of decode it reports."""
    if in_process:
        from adfmsl_torch.cli import pack

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pack.main(argv)
        out, err = buf.getvalue(), ""
    else:
        p = subprocess.run([sys.executable, "-m", "adfmsl_torch.cli.pack", *argv],
                           capture_output=True, text=True, cwd=str(ROOT),
                           timeout=PACK_LIMIT)
        rc, out, err = p.returncode, p.stdout, p.stderr
    check(rc == 0, f"cli.pack {argv}: exited {rc}: {err[-3000:]}")
    line = out.strip().splitlines()[-1]
    check(line.startswith("packed ") and line.endswith(" utt/s decode)"),
          f"cli.pack printed {line!r}")
    return line, float(line.rsplit("(", 1)[1].split()[0])


def _read_scores(path):
    with open(path) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()]
    return [r[0] for r in rows], np.asarray([float(r[1]) for r in rows])


def phase_packs(rf, sf, fixture, tmp, card, native=None):
    """Packs on the card (``packs``, phase 7h). (a) the fixture's eval split
    packed by ``python -m adfmsl_torch.cli.pack`` from its WAV files and from
    its FLAC twin (equal arrays), maze5 scored by ``cli.evaluate --pack`` (K1
    5 a batch) against the ``--data_dir`` run's score file (equal bytes);
    (b) RawNet main from a YAML with ``fused_train_frontend`` through
    ``cli.train --train_pack --dev_pack`` (K3 and K3-bwd once a step), then
    ``--eval --eval_pack`` against ``--eval --eval_dir``; (c) a ``Trainer``
    with ``data.augment_enabled``, the pack's loader, a noise bank of
    ``PACK_NOISE_CLIPS`` fixture clips and an RIR bank of ``PACK_RIRS``
    ``synthetic_rir`` of ``PACK_RIR_LEN``: K3 / K3-bwd once a step, finite
    losses unlike the same steps' without banks, gated-off rows reaching the
    model as loaded; the gate rates and the augmentation's ms a step against
    the step's; (d) the 256 four-second FLAC utterances of ``loader_corpus``
    packed, ``PackedDataset.load_batch``'s host utt/s beside FLAC's at 1, 2, 4
    and 8 threads (``native``'s, else measured here) and ``cli.pack``'s
    decode rate; (e) ``cli.train --data_parallel 2 --dist_backend gloo
    --train_pack``, one epoch of 2 maze5 steps, the ranks sharing the card."""
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.config import load_yaml, make_experiment, save_yaml
    from adfmsl_torch.data import (AsvspoofDataset, PackedDataset, draw_augment,
                                   parse_protocol, synthetic_rir)
    from adfmsl_torch.data.augment import augment_waveform
    from adfmsl_torch.data.flac import flac_twin
    from adfmsl_torch.train import CheckpointManager, Trainer, make_dataset_and_loader

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "packs")
    os.makedirs(root)
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]
    dev = torch.device("cuda", 0)
    rec = {"card": card, "cut": CUT}

    # (a)
    flac_dir = os.path.join(root, "eval_flac")
    flac_twin(ev["audio_dir"], flac_dir)
    prefix = {k: os.path.join(root, f"eval_{k}") for k in ("wav", "flac")}
    # the WAV split through the module's entry point, the rest through its main
    lines = {k: pack_cli(["--protocol", ev["protocol"], "--data_dir", d, "--out_prefix",
                          prefix[k]], in_process=k == "flac")[0]
             for k, d in (("wav", ev["audio_dir"]), ("flac", flac_dir))}
    check(np.array_equal(np.load(prefix["wav"] + ".npy"), np.load(prefix["flac"] + ".npy")),
          "packs (a): the FLAC twin's pack differs from the WAV split's")
    outs = {k: os.path.join(root, f"maze5_{k}_scores.txt") for k in ("data_dir", "pack")}
    k1, k5 = {}, {}
    for k, src in (("data_dir", ["--data_dir", ev["audio_dir"], "--cut", str(CUT)]),
                   ("pack", ["--pack", prefix["flac"]])):
        rf.resblock_eval.launches = 0
        k5_before = k5_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = evaluate.main(["--model_type", "maze5", "--protocol", ev["protocol"], *src,
                                "--output", outs[k], "--batch_size", str(EVAL_BATCH),
                                "--device", "cuda", "--seed", "0"])
        torch.cuda.synchronize()
        k1[k] = rf.resblock_eval.launches
        k5[k] = k5_launches() - k5_before
        check(rc == 0, f"packs (a): maze5 evaluate from the {k} exited {rc}")
    n_batches = -(-EVAL_UTTS // EVAL_BATCH)
    check(k1["pack"] == K1_MAZE5 * n_batches,
          f"packs (a): K1 launched {k1['pack']} times, expected {K1_MAZE5 * n_batches}")
    check(k5["pack"] == k5["data_dir"] == n_batches,
          f"packs (a): K5 launched {k5} times, expected {n_batches} each")
    (ids_d, s_d), (ids_p, s_p) = _read_scores(outs["data_dir"]), _read_scores(outs["pack"])
    check(ids_d == ids_p == ev["utt_ids"] and bool(np.isfinite(s_p).all()),
          "packs (a): score file ids or values")
    with open(outs["data_dir"], "rb") as a, open(outs["pack"], "rb") as b:
        same = a.read() == b.read()
    rec["a"] = {"wall_s": time.perf_counter() - t_phase,
                "model": "maze5", "batch": EVAL_BATCH, "batches": n_batches,
                "pack_lines": lines, "k1_launches": k1["pack"],
                "k1_launches_data_dir": k1["data_dir"], "k5_launches": k5,
                "scores_max_abs_diff": float(np.abs(s_p - s_d).max()),
                "score_files_identical": same}
    print("packs_a " + json.dumps(rec["a"]), flush=True)
    check(same, "packs (a): the pack's score file differs from the --data_dir run's")

    # (b)
    t_part = time.perf_counter()
    packs = {}
    for split, f in (("train", tr), ("dev", dv)):
        packs[split] = os.path.join(root, split)
        pack_cli(["--protocol", f["protocol"], "--data_dir", f["audio_dir"], "--out_prefix",
                  packs[split]])
    exp = make_experiment("main")
    exp.train.batch_size, exp.train.num_epochs = TRAIN_BATCH, CONFIG_CLI_EPOCHS
    exp.train.keep_best_k = CONFIG_CLI_EPOCHS        # both epochs' metrics stay
    exp.model.extra.update(K3_TRAIN)
    cfg = os.path.join(root, "main_k3.yaml")
    save_yaml(exp, cfg)
    ck = os.path.join(root, "main_ck")
    common = ["--config", cfg, "--train_protocol", tr["protocol"], "--dev_protocol",
              dv["protocol"], "--checkpoint_dir", ck, "--device", "cuda"]
    sf.sinc_abs_pool_fused.launches = sf.sinc_abs_pool_bwd.launches = 0
    t0 = time.perf_counter()
    rc = cli_train.main(common + ["--train_pack", packs["train"], "--dev_pack", packs["dev"]])
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    k3, k3b = sf.sinc_abs_pool_fused.launches, sf.sinc_abs_pool_bwd.launches
    n_steps = CONFIG_CLI_EPOCHS * (TRAIN_UTTS // TRAIN_BATCH)
    check(rc == 0, f"packs (b): cli.train --train_pack exited {rc}")
    check(k3 == n_steps and k3b == n_steps,
          f"packs (b): K3 {k3} and K3-bwd {k3b} launches in {n_steps} steps")
    mgr = CheckpointManager(ck)
    epochs = [mgr.metrics(e) for e in mgr.all_epochs()]
    check(bool(epochs) and all(math.isfinite(m["train_loss"]) for m in epochs),
          f"packs (b): epoch metrics {epochs}")
    check(load_yaml(os.path.join(ck, "experiment.yaml")).data.cut == CUT,
          "packs (b): experiment.yaml's cut")
    souts = {k: os.path.join(root, f"main_{k}_scores.txt") for k in ("eval_dir", "eval_pack")}
    for k, src in (("eval_dir", ["--eval_dir", ev["audio_dir"]]),
                   ("eval_pack", ["--eval_pack", prefix["wav"]])):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_train.main(common + ["--train_pack", packs["train"], "--restore",
                                          "--eval", "--eval_protocol", ev["protocol"],
                                          "--eval_output", souts[k], *src])
        torch.cuda.synchronize()
        check(rc == 0, f"packs (b): cli.train --eval from the {k} exited {rc}")
    (ids_d, s_d), (ids_p, s_p) = (_read_scores(souts["eval_dir"]),
                                  _read_scores(souts["eval_pack"]))
    check(ids_d == ids_p == ev["utt_ids"] and bool(np.isfinite(s_p).all()),
          "packs (b): score file ids or values")
    with open(souts["eval_dir"], "rb") as a, open(souts["eval_pack"], "rb") as b:
        same = a.read() == b.read()
    rec["b"] = {"model": "main", "extra": K3_TRAIN, "batch": TRAIN_BATCH, "steps": n_steps,
                "k3_launches": k3, "k3_bwd_launches": k3b,
                "train_loss": [m["train_loss"] for m in epochs], "train_cli_wall_s": wall_b,
                "wall_s": time.perf_counter() - t_part,
                "scores_max_abs_diff": float(np.abs(s_p - s_d).max()),
                "score_files_identical": same}
    print("packs_b " + json.dumps(rec["b"]), flush=True)
    check(same, "packs (b): --eval_pack's score file differs from --eval_dir's")

    # (c)
    t_part = time.perf_counter()
    exp = make_experiment("main")
    exp.train.batch_size, exp.train.num_epochs, exp.train.log_every_steps = TRAIN_BATCH, 1, 0
    exp.model.extra.update(K3_TRAIN)
    exp.data.augment_enabled = True
    dcfg = exp.data
    proto = parse_protocol(tr["protocol"], dcfg.label_polarity)
    noise = PackedDataset(packs["dev"]).load_batch(dv["utt_ids"][:PACK_NOISE_CLIPS])[0]
    rirs = torch.stack([synthetic_rir(torch.Generator(device=dev).manual_seed(i),
                                      PACK_RIR_LEN) for i in range(PACK_RIRS)])
    steps = TRAIN_UTTS // TRAIN_BATCH
    runs = {}
    for key, banks in (("augmented", {"noise_bank": noise, "rir_bank": rirs}), ("plain", {})):
        trainer = Trainer(exp, make_dataset_and_loader(exp, proto, None, shuffle=True,
                                                       pack=packs["train"]),
                          None, device=dev, **banks)
        seen, loaded, losses = [], [], []
        hook = trainer.state.model.register_forward_pre_hook(
            lambda mod, args: seen.append(args[0].detach().clone()) if mod.training else None)
        place, step = trainer._place, trainer.train_step

        def placed(batch, index=None, place=place, loaded=loaded):
            out = place(batch, index)
            loaded.append(out[0].clone())
            return out

        def stepped(*a, step=step, losses=losses):
            met = step(*a)
            losses.append(float(met["loss"]))
            return met

        trainer._place, trainer.train_step = placed, stepped
        sf.sinc_abs_pool_fused.launches = sf.sinc_abs_pool_bwd.launches = 0
        trainer.fit()
        torch.cuda.synchronize()
        k3, k3b = sf.sinc_abs_pool_fused.launches, sf.sinc_abs_pool_bwd.launches
        hook.remove()
        check(k3 == steps and k3b == steps,
              f"packs (c) {key}: K3 {k3} and K3-bwd {k3b} launches in {steps} steps")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"packs (c) {key}: losses {losses}")
        x, y, m = placed(next(iter(trainer.train_loader)))
        gens = trainer.state.generators(1, 0)
        step_ms = cuda_ms(lambda: step(trainer.state, x, y, m, gens))
        runs[key] = {"k3_launches": k3, "k3_bwd_launches": k3b, "losses": losses,
                     "step_ms": step_ms, "seen": seen, "loaded": loaded, "trainer": trainer}
    aug = runs["augmented"]
    check(aug["losses"] != runs["plain"]["losses"],
          "packs (c): the augmented steps' losses equal the plain steps'")
    gates_n, gates_r = [], []
    for i in range(steps):
        d = draw_augment(TRAIN_BATCH, aug["trainer"].state.generators(0, i)["augment"],
                         PACK_NOISE_CLIPS, PACK_RIRS, dcfg.augment_snr_db_min,
                         dcfg.augment_snr_db_max)
        on_n = (d.noise_u < dcfg.augment_noise_prob).squeeze(1)
        on_r = (d.reverb_u < dcfg.augment_reverb_prob).squeeze(1)
        gates_n.append(on_n)
        gates_r.append(on_r)
        off = ~(on_n | on_r)
        check(torch.equal(aug["seen"][i][off], aug["loaded"][i][off]),
              f"packs (c): step {i}'s gated-off rows differ from the loaded audio")
        check(bool((aug["seen"][i][~off] != aug["loaded"][i][~off]).any(dim=1).all()),
              f"packs (c): step {i}'s gated-on rows reached the model unchanged")
    nb = torch.from_numpy(noise).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = aug["loaded"][0]
    aug_ms = cuda_ms(lambda: augment_waveform(
        x0, g, nb, rirs, dcfg.augment_noise_prob, dcfg.augment_reverb_prob,
        dcfg.augment_snr_db_min, dcfg.augment_snr_db_max))
    rec["c"] = {"model": "main", "extra": K3_TRAIN, "batch": TRAIN_BATCH, "steps": steps,
                "noise_clips": PACK_NOISE_CLIPS, "rirs": PACK_RIRS, "rir_len": PACK_RIR_LEN,
                "probs": [dcfg.augment_noise_prob, dcfg.augment_reverb_prob],
                **{f"{k}_{f}": runs[k][f] for k in runs
                   for f in ("k3_launches", "k3_bwd_launches", "losses", "step_ms")},
                "noise_gate_rate": float(torch.cat(gates_n).float().mean()),
                "reverb_gate_rate": float(torch.cat(gates_r).float().mean()),
                "rows": steps * TRAIN_BATCH, "augment_ms": aug_ms,
                "wall_s": time.perf_counter() - t_part,
                "fft_points": int(2 ** np.ceil(np.log2(CUT + PACK_RIR_LEN - 1)))}
    print("packs_c " + json.dumps(rec["c"]), flush=True)
    del runs, aug
    torch.cuda.empty_cache()

    # (d)
    t_part = time.perf_counter()
    proto_path, ids, dirs = loader_corpus(tmp)
    loader_prefix = os.path.join(root, "loader_flac")
    line, decode = pack_cli(["--protocol", proto_path, "--data_dir", dirs["flac"],
                             "--out_prefix", loader_prefix])
    lproto = parse_protocol(proto_path)
    rates = {"pack": loader_rate(PackedDataset(loader_prefix, lproto), ids, "pack")}
    if native is not None:
        rates.update({k: v for k, v in native["loader"].items() if k.startswith("flac")})
    else:
        rates.update({f"flac_native_w{w}": loader_rate(
            AsvspoofDataset(lproto, dirs["flac"], cut=CUT, num_workers=w), ids,
            f"flac_native_w{w}") for w in LOADER_WORKERS})
    rec["d"] = {"utterances": LOADER_UTTS, "seconds_each": LOADER_SECONDS,
                "batch": BENCH_BATCH, "cpu_count": os.cpu_count(), "pack_line": line,
                "pack_decode_utt_per_s": decode, "pack_bytes": LOADER_UTTS * CUT * 4,
                "loader": rates, "wall_s": time.perf_counter() - t_part}
    print("packs_d " + json.dumps(rec["d"]), flush=True)

    # (e)
    md_proto = os.path.join(root, "train_md.txt")
    with open(tr["protocol"]) as fh:
        head = fh.read().splitlines()[:PACK_MD_UTTS]
    with open(md_proto, "w") as fh:
        fh.write("\n".join(head) + "\n")
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "adfmsl_torch.cli.train", "--model", "maze5",
                          "--train_protocol", md_proto, "--train_pack", packs["train"],
                          "--protocols_path", os.path.join(root, "no_protocols"),
                          "--batch_size", str(TRAIN_BATCH), "--num_epochs", "1",
                          "--checkpoint_dir", os.path.join(root, "md_ck"),
                          "--data_parallel", "2", "--dist_backend", "gloo",
                          "--dist_timeout", str(MD_LIMIT), "--device", "cuda"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         cwd=str(ROOT), start_new_session=True)
    try:
        stdout, stderr = p.communicate(timeout=MD_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)      # the CLI and the ranks it spawned
        p.communicate()
        raise
    check(p.returncode == 0, f"packs (e): CLI exited {p.returncode}: {stderr[-3000:]}")
    ranks = [ln for ln in stdout.splitlines() if ln.startswith("rank_summary ")]
    for ln in ranks:
        print(ln, flush=True)
    md = CheckpointManager(os.path.join(root, "md_ck")).metrics(0)
    rec["e"] = {"model": "maze5", "global_batch": TRAIN_BATCH,
                "steps": PACK_MD_UTTS // TRAIN_BATCH, "ranks": len(ranks),
                "train_loss": md["train_loss"], "wall_s": time.perf_counter() - t0,
                "note": MD_SHARED}
    print("packs_e " + json.dumps(rec["e"]), flush=True)
    check(len(ranks) == 2 and math.isfinite(md["train_loss"]),
          f"packs (e): {len(ranks)} rank summaries, train loss {md['train_loss']}")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def _cli_quiet(main, argv):
    """``main(argv)`` with its standard output captured: (rc, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


class _LaunchMarks(logging.Handler):
    """Snapshots kernel launch counters whenever the batch CLI logs the start
    of a model (``=== training <model> ===``)."""

    def __init__(self, counters):
        super().__init__(logging.INFO)
        self.counters, self.marks = counters, []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("=== training "):
            self.marks.append((msg.split()[2], {k: c.launches for k, c in
                                                self.counters.items()}))


def bn_act_case(dev):
    """(e): ``BNAct`` in train mode at maze5 block0's shape, bf16, 'selu',
    against the plain composition (f32 ``F.batch_norm`` -> SELU -> bf16 under
    autograd) on the same input, weights and cotangent."""
    from adfmsl_torch.ops import BNAct

    b, t, c = BNACT_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(b, t, c, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(b, t, c, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev) * 0.1
    mod = BNAct(c, act="selu", dtype=torch.bfloat16).to(dev).train()
    with torch.no_grad():
        mod.scale.copy_(scale)
        mod.bias.copy_(bias)
    w, bb = scale.clone().requires_grad_(), bias.clone().requires_grad_()

    def plain(xx):
        z = F.batch_norm(xx.float().reshape(-1, c), None, None, w, bb, training=True,
                         eps=1e-5)
        return F.selu(z).reshape(xx.shape).to(torch.bfloat16)

    cases = (("bn_act", mod, [mod.scale, mod.bias]), ("composition", plain, [w, bb]))
    outs = {}
    for name, fn, params in cases:
        xx = x.clone().requires_grad_()
        y = fn(xx)
        y.backward(dy)
        outs[name] = [y.detach().float(), xx.grad.float()] + [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
    # one train-mode call from the initial statistics (0, 1): momentum 0.9 on
    # the one-pass biased variance
    xf = x.float().reshape(-1, c)
    mean = xf.mean(0)
    var = (xf * xf).mean(0) - mean * mean
    stats_err = max(float((mod.mean - 0.1 * mean).abs().max()),
                    float((mod.var - (0.9 + 0.1 * var)).abs().max()))
    check(stats_err <= 1e-5 * max(1.0, float(var.abs().max())),
          f"analysis (e): BNAct's running statistics off by {stats_err}")
    rec = {"shape": list(BNACT_SHAPE), "dtype": "bfloat16", "act": "selu",
           "running_stats_max_abs_err": stats_err, "errors": {}}
    for i, key in enumerate(("y", "dx", "dscale", "dbias")):
        got, ref = outs["bn_act"][i], outs["composition"][i]
        tol = BNACT_TOL * max(1.0, float(ref.abs().max()))
        rec["errors"][key] = {"max_abs_err": float((got - ref).abs().max()), "tol": tol}
        check(bool(torch.isfinite(got).all()) and rec["errors"][key]["max_abs_err"] <= tol,
              f"analysis (e): BNAct {key} {rec['errors'][key]}")
    del outs
    for name, fn, params in cases:
        def forward(fn=fn):
            with torch.no_grad():
                fn(x)

        def step(fn=fn, params=params):
            fn(x.detach().requires_grad_()).backward(dy)
            for p in params:
                p.grad = None

        rec[f"{name}_fwd_ms"] = cuda_ms(forward)
        rec[f"{name}_fwd_bwd_ms"] = cuda_ms(step)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xi = x.detach().requires_grad_()
        yi = fn(xi)
        rec[f"{name}_held_after_fwd_mib"] = (torch.cuda.memory_allocated() - base) / 2 ** 20
        yi.backward(dy)
        torch.cuda.synchronize()
        rec[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del xi, yi
        for p in params:
            p.grad = None
    torch.cuda.empty_cache()
    return rec


def phase_analysis(rf, sf, tmp, card):
    """Embeddings, the analysis layer, the batch CLI, the bootstrap, ``BNAct``
    and the msgpack export on the card (``analysis``, phase 7i), on a fixture
    of ``ANALYSIS_UTTS`` eval, ``TRAIN_UTTS`` train and ``DEV_UTTS`` dev
    utterances at cut 64600, random weights from seed 0. (a) maze5 and
    maze5_fmsl through ``cli.evaluate`` at batch 128, without and with
    ``--dump_embeddings`` (K1 5 a batch both times, equal score files), then
    ``--no_fused_trunk --dump_embeddings``: features (256, 1024), finite, the
    K1 run's within 3e-3 * max(1, |x|) of the unfolded trunk's; maze5_fmsl's
    prototypes and class weights unit rows within 1e-6. (c) ``cli.batch`` of
    maze5 (``fused_eval_trunk``) and main (``fused_train_frontend``,
    ``fused_eval_trunk``; each keeps its own ``extra`` keys), one epoch at batch
    12: K3 and K3-bwd once a main train step, K1 5 a maze5 and 6 a main dev or
    eval batch (counted between the CLI's per-model log lines); its
    ``results.csv``, ``report.md`` and score files. (b) ``cli.analyze`` over
    (a)'s two score files with ``--figures``, ``--embeddings`` on (a)'s dumps
    and ``--curves`` on metric logs written from (c)'s checkpoints (rc 0, the
    files it wrote), then ``--regression 0.001`` (rc 2: random weights miss
    the thesis's EERs), then ``cli.compare`` of the two at 1,000 resamples;
    without matplotlib the figures are left out and said so. (d) on the host,
    ``bootstrap_metric`` and ``paired_bootstrap_test`` at 1,000 resamples over
    71,237 seeded scores (the LA eval list's size and bonafide count): their
    seconds. (e) ``bn_act_case``. (f) ``save_native`` of a random base
    encoder's flax tree (from ``tests/torch_ref_nets.py:hf_layout_state_dict``), ``load_native`` and
    ``flax_tree_to_state_dict`` into a fresh encoder on the card: its output on
    a (4, 64600) batch equals the original's bit for bit; ``cli.convert
    --verify`` of the same HF-layout checkpoint writes the same bytes."""
    import yaml

    from adfmsl_torch.cli import analyze, batch, compare, convert, evaluate
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import SyntheticSpec, generate_fixture
    from adfmsl_torch.evaluation import bootstrap_metric, paired_bootstrap_test
    from adfmsl_torch.models.port import flax_tree_to_state_dict
    from adfmsl_torch.models.pretrained import load_native, save_native
    from adfmsl_torch.models.w2v2 import W2V2Arch, Wav2Vec2Encoder, port_hf_state_dict
    from adfmsl_torch.train import CheckpointManager
    from adfmsl_torch.utils import MetricsLogger

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    root = os.path.join(tmp, "analysis")
    fx = generate_fixture(os.path.join(root, "fixture"), SyntheticSpec(
        n_train=TRAIN_UTTS, n_dev=DEV_UTTS, n_eval=ANALYSIS_UTTS))
    tr, dv, ev = fx["train"], fx["dev"], fx["eval"]
    rec = {"card": card, "cut": CUT}
    try:
        import matplotlib  # noqa: F401  (host-only figures)
        figures = True
    except ImportError:
        figures = False
        print("figures: matplotlib not installed", flush=True)

    # (a)
    t_part = time.perf_counter()
    scores_dir = os.path.join(root, "scores")
    n_batches = -(-ANALYSIS_UTTS // BENCH_BATCH)
    rec["a"], dumps = {}, []
    for name in ("maze5", "maze5_fmsl"):
        common = ["--model_type", name, "--protocol", ev["protocol"], "--data_dir",
                  ev["audio_dir"], "--batch_size", str(BENCH_BATCH), "--cut", str(CUT),
                  "--device", "cuda", "--seed", "0"]
        runs = {}
        for key, extra in (("plain", []), ("dump", []), ("unfolded", ["--no_fused_trunk"])):
            out = (os.path.join(scores_dir, f"{name}_scores.txt") if key == "dump"
                   else os.path.join(root, f"{name}_{key}_scores.txt"))
            npz = os.path.join(root, f"{name}_{key}.npz")
            argv = common + ["--output", out] + extra + (
                ["--dump_embeddings", npz] if key != "plain" else [])
            rf.resblock_eval.launches = 0
            t0 = time.perf_counter()
            rc, _ = _cli_quiet(evaluate.main, argv)
            torch.cuda.synchronize()
            runs[key] = {"k1": rf.resblock_eval.launches, "out": out, "npz": npz,
                         "wall_s": time.perf_counter() - t0}
            check(rc == 0, f"analysis (a): {name} evaluate {key} exited {rc}")
        with open(runs["plain"]["out"], "rb") as a, open(runs["dump"]["out"], "rb") as b:
            same = a.read() == b.read()
        with np.load(runs["dump"]["npz"]) as z, np.load(runs["unfolded"]["npz"]) as u:
            files = sorted(z.files)
            ids, feats, feats_u = [str(s) for s in z["utt_ids"]], z["features"], u["features"]
            units = {k: float(np.abs(np.linalg.norm(z[k], axis=-1) - 1.0).max())
                     for k in ("prototypes", "class_weights") if k in z.files}
        feat_tol = 3e-3 * max(1.0, float(np.abs(feats_u).max()))
        r = {"card": card, "batch": BENCH_BATCH, "utterances": ANALYSIS_UTTS, "batches": n_batches,
             "k1_launches": runs["dump"]["k1"], "k1_launches_without_flag": runs["plain"]["k1"],
             "k1_launches_no_fused_trunk": runs["unfolded"]["k1"],
             "score_files_identical": same, "npz_keys": files,
             "features_shape": list(feats.shape),
             "features_max_abs_err_vs_unfolded": float(np.abs(feats - feats_u).max()),
             "features_tol": feat_tol, "unit_row_max_err": units,
             "wall_s": {k: v["wall_s"] for k, v in runs.items()}}
        rec["a"][name] = r
        print(f"analysis_a_{name} " + json.dumps(r), flush=True)
        check(runs["plain"]["k1"] == runs["dump"]["k1"] == K1_MAZE5 * n_batches
              and runs["unfolded"]["k1"] == 0,
              f"analysis (a): {name} K1 launches {r['k1_launches_without_flag']} / "
              f"{r['k1_launches']} / {r['k1_launches_no_fused_trunk']}")
        check(same, f"analysis (a): {name}'s score file differs with --dump_embeddings")
        check(ids == ev["utt_ids"] and feats.shape == (ANALYSIS_UTTS, 1024)
              and bool(np.isfinite(feats).all()), f"analysis (a): {name} features {feats.shape}")
        check(r["features_max_abs_err_vs_unfolded"] <= feat_tol,
              f"analysis (a): {name} features off the unfolded trunk's")
        check(len(units) == (2 if name.endswith("_fmsl") else 0)
              and all(v <= 1e-6 for v in units.values()),
              f"analysis (a): {name} prototype / class weight rows {units}")
        dumps.append(runs["dump"]["npz"])
    rec["a"]["wall_s"] = time.perf_counter() - t_part

    # (c)
    t_part = time.perf_counter()
    extras = {"maze5": {"fused_eval_trunk": True},
              "main": {**K3_TRAIN, "fused_eval_trunk": True}}
    plan = {"models": ["maze5", "main"],
            "overrides": {"train.num_epochs": 1, "train.batch_size": TRAIN_BATCH,
                          "train.eval_batch_size": BENCH_BATCH, "data.cut": CUT},
            "per_model": {m: {"model.extra": {**make_experiment(m).model.extra, **e}}
                          for m, e in extras.items()}}
    plan_path = os.path.join(root, "plan.yaml")
    with open(plan_path, "w") as fh:
        yaml.safe_dump(plan, fh)
    out_dir = os.path.join(root, "batch_out")
    counters = {"k1": rf.resblock_eval, "k3": sf.sinc_abs_pool_fused,
                "k3_bwd": sf.sinc_abs_pool_bwd}
    for c in counters.values():
        c.launches = 0
    marks = _LaunchMarks(counters)
    logging.getLogger().addHandler(marks)
    try:
        with root_log_lines():
            rc, text = _cli_quiet(batch.main, [
                "--config", plan_path, "--train_protocol", tr["protocol"],
                "--train_dir", tr["audio_dir"], "--dev_protocol", dv["protocol"],
                "--dev_dir", dv["audio_dir"], "--eval_protocol", ev["protocol"],
                "--eval_dir", ev["audio_dir"], "--output_dir", out_dir, "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        logging.getLogger().removeHandler(marks)
    check(rc == 0, f"analysis (c): cli.batch exited {rc}")
    end = {k: c.launches for k, c in counters.items()}
    starts = [m[1] for m in marks.marks] + [end]
    by_model = {m[0]: {k: starts[i + 1][k] - starts[i][k] for k in counters}
                for i, m in enumerate(marks.marks)}
    steps = TRAIN_UTTS // TRAIN_BATCH
    eval_batches = -(-DEV_UTTS // BENCH_BATCH) + n_batches    # dev pass + eval protocol
    want = {"maze5": {"k1": K1_MAZE5 * eval_batches, "k3": 0, "k3_bwd": 0},
            "main": {"k1": 6 * eval_batches, "k3": steps, "k3_bwd": steps}}
    written = sorted(os.listdir(out_dir)) + sorted(
        f"scores/{f}" for f in os.listdir(os.path.join(out_dir, "scores")))
    score_ok = {}
    for m in plan["models"]:
        ids, s = _read_scores(os.path.join(out_dir, "scores", f"{m}_scores.txt"))
        score_ok[m] = ids == ev["utt_ids"] and bool(np.isfinite(s).all())
    rec["c"] = {"card": card, "plan": plan, "train_batch": TRAIN_BATCH, "steps_per_model": steps,
                "eval_batch": BENCH_BATCH, "dev_and_eval_batches": eval_batches,
                "launches": by_model, "expected": want, "files": written,
                "summary": text.strip().splitlines()[-2:],
                "wall_s": time.perf_counter() - t_part}
    print("analysis_c " + json.dumps(rec["c"]), flush=True)
    check(by_model == want, f"analysis (c): launches {by_model}, expected {want}")
    check(all(score_ok.values()), f"analysis (c): score files {score_ok}")
    check({"results.csv", "report.md", "scores/maze5_scores.txt",
           "scores/main_scores.txt"} <= set(written), f"analysis (c): wrote {written}")

    # (b)
    t_part = time.perf_counter()
    logs = []
    for m in plan["models"]:
        mgr = CheckpointManager(os.path.join(out_dir, "ckpts", m))
        d = os.path.join(root, "logs", m)
        log = MetricsLogger(d, also_tensorboard=False)
        for e in mgr.all_epochs():
            met = mgr.metrics(e)
            log.add_scalars({"train/loss": met["train_loss"], "train/acc": met["train_acc"],
                             "dev/acc": met["dev_acc"]}, e)
        log.close()
        logs += ["--curves", d]
    an_dir = os.path.join(root, "analyze_out")
    base = ["--scores_dir", scores_dir, "--protocol", ev["protocol"], "--output_dir", an_dir]
    extra = ["--figures", *[a for p in dumps for a in ("--embeddings", p)], *logs]
    rc0, text0 = _cli_quiet(analyze.main, base + (extra if figures else []))
    files = sorted(os.listdir(an_dir))
    rc2, text2 = _cli_quiet(analyze.main, base + ["--regression", "0.001"])
    cmp_dir = os.path.join(root, "compare_out")
    t0 = time.perf_counter()
    rc_cmp, text_cmp = _cli_quiet(compare.main, [
        "--scores_a", os.path.join(scores_dir, "maze5_scores.txt"),
        "--scores_b", os.path.join(scores_dir, "maze5_fmsl_scores.txt"),
        "--protocol", ev["protocol"], "--output_dir", cmp_dir,
        "--n_resamples", str(BOOT_RESAMPLES), *([] if figures else ["--no_figures"])])
    cmp_s = time.perf_counter() - t0
    want_files = {"processed_performance_data.json", "results.csv", "results.tex",
                  "report.md"}
    if figures:
        want_files |= {"roc.png", "det.png", "model_comparison.png", "maze5_score_dist.png",
                       "maze5_fmsl_score_dist.png", "trend_visualizations.png",
                       "comprehensive_histogram.png", "training_curves.png",
                       *(f"embedding_geometry_{os.path.splitext(os.path.basename(p))[0]}.png"
                         for p in dumps)}
    rec["b"] = {"card": card, "figures": figures, "analyze_rc": rc0, "files": files,
                "regression_rc": rc2,
                "regression_lines": [ln for ln in text2.splitlines()
                                     if ln.startswith("regression")],
                "compare_rc": rc_cmp, "compare_files": sorted(os.listdir(cmp_dir)),
                "compare_s": cmp_s, "compare_resamples": BOOT_RESAMPLES,
                "compare_verdict": [ln for ln in text_cmp.splitlines()
                                    if ln.startswith(("Paired", "**Better"))],
                "wall_s": time.perf_counter() - t_part}
    print("analysis_b " + json.dumps(rec["b"]), flush=True)
    check(rc0 == 0 and want_files <= set(files), f"analysis (b): analyze rc {rc0}, {files}")
    check(rc2 == 2, f"analysis (b): --regression 0.001 returned {rc2}, expected 2")
    check(rc_cmp == 0 and "comparison.md" in rec["b"]["compare_files"],
          f"analysis (b): compare rc {rc_cmp}")

    # (d)
    rng = np.random.default_rng(0)
    y = np.zeros(BOOT_UTTS, dtype=int)
    y[rng.choice(BOOT_UTTS, BOOT_BONAFIDE, replace=False)] = 1
    sa, sb = y * 2.0 + rng.normal(0, 1, BOOT_UTTS), y * 1.5 + rng.normal(0, 1, BOOT_UTTS)
    t0 = time.perf_counter()
    boot = bootstrap_metric(sa, y, n_resamples=BOOT_RESAMPLES, seed=0)
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paired = paired_bootstrap_test(sa, sb, y, n_resamples=BOOT_RESAMPLES, seed=0)
    paired_s = time.perf_counter() - t0
    rec["d"] = {"card": card, "utterances": BOOT_UTTS, "bonafide": BOOT_BONAFIDE,
                "resamples": BOOT_RESAMPLES, "cpu_count": os.cpu_count(),
                "bootstrap_metric_s": boot_s, "paired_bootstrap_test_s": paired_s,
                "eer": [boot.point, boot.ci_low, boot.ci_high], "paired": paired}
    print("analysis_d " + json.dumps(rec["d"]), flush=True)
    check(boot.ci_low <= boot.point <= boot.ci_high and 0 <= paired["p_value"] <= 1,
          f"analysis (d): {rec['d']}")

    # (e)
    rec["e"] = {"card": card, **bn_act_case(dev)}
    print("analysis_e " + json.dumps(rec["e"]), flush=True)

    # (f)
    t_part = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ref_nets import hf_layout_state_dict

    arch = W2V2Arch.base()
    hf = hf_layout_state_dict(arch, seed=0)
    hf_path = os.path.join(root, "w2v2_hf.bin")
    torch.save(hf, hf_path)
    tree = port_hf_state_dict({k: v.numpy() for k, v in hf.items()}, arch)
    native = os.path.join(root, "w2v2_base.msgpack")
    t0 = time.perf_counter()
    save_native(tree, native)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_native(native)
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, CUT))
                         .astype(np.float32)).to(dev)
    outs = []
    for t in (tree, back):
        enc = Wav2Vec2Encoder(arch, normalize_input=False).to(dev).eval()
        enc.load_state_dict(flax_tree_to_state_dict(t), strict=True)
        with torch.inference_mode():
            outs.append(enc(x))
        del enc
    conv_path = os.path.join(root, "w2v2_convert.msgpack")
    rc, text = _cli_quiet(convert.main, ["--torch_ckpt", hf_path, "--arch", "base", "--out",
                                         conv_path, "--verify", "--device", "cuda"])
    with open(native, "rb") as a, open(conv_path, "rb") as b:
        same_file = a.read() == b.read()
    rec["f"] = {"card": card, "arch": "base", "params": int(sum(v.numel() for v in hf.values())),
                "file_bytes": os.path.getsize(native), "save_s": save_s, "load_s": load_s,
                "batch": [4, CUT], "output_shape": list(outs[0].shape),
                "outputs_identical": bool(torch.equal(outs[0], outs[1])),
                "finite": bool(torch.isfinite(outs[0]).all()), "convert_rc": rc,
                "convert_lines": text.strip().splitlines(),
                "convert_file_identical": same_file, "wall_s": time.perf_counter() - t_part}
    print("analysis_f " + json.dumps(rec["f"]), flush=True)
    check(rec["f"]["outputs_identical"] and rec["f"]["finite"],
          "analysis (f): the reloaded encoder's output differs")
    check(rc == 0 and same_file, f"analysis (f): cli.convert rc {rc}, same file {same_file}")
    del outs, back, tree
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def _ref_net(name, nets):
    """The independent torch reference of ``name`` (tests/torch_ref_nets.py);
    column 1 of its output (a log-softmax, or maze4_fmsl's raw logits) is the
    score."""
    from adfmsl_torch.config import make_experiment

    if name in ("maze5", "maze5_fmsl"):
        return nets.TMaze5(fmsl=name == "maze5_fmsl")
    if name == "maze4_fmsl":
        return nets.TMaze4FMSL(s=make_experiment(name).model.fmsl.s)
    return nets.TRawNet(gru_layers=REF_GRU_LAYERS)


def _score_file(path, ids):
    with open(path) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()]
    check([r[0] for r in rows] == ids, f"{path}: score file ids differ from the protocol")
    return np.asarray([float(r[1]) for r in rows])


def _fixture_audio(exp, split, n=None):
    """The split's utterances as ``cli.evaluate`` loads them for ``exp``."""
    from adfmsl_torch.data import AsvspoofDataset, parse_protocol

    proto = parse_protocol(split["protocol"], exp.data.label_polarity)
    ds = AsvspoofDataset(proto, split["audio_dir"], cut=exp.data.cut,
                         pad_mode=exp.data.pad_mode, sample_rate=exp.data.sample_rate,
                         use_native_io=exp.data.use_native_io,
                         num_workers=exp.data.num_workers)
    ids = proto.utt_ids[:n] if n else proto.utt_ids
    return torch.from_numpy(np.stack([ds.load(u)[0] for u in ids]))


def _batched_scores(fn, audio, dev):
    with torch.no_grad():
        return torch.cat([fn(audio[i:i + EVAL_BATCH].to(dev)).float().cpu()
                          for i in range(0, len(audio), EVAL_BATCH)]).numpy()


def phase_reference_ckpt(rf, sf, tmp, dev, card):
    """Thesis-style torch checkpoints through ``cli.convert_maze`` on the card
    (``reference_ckpt``), on a fixture of 16 eval, 24 train and 12 dev
    utterances at cut 64600. (a) maze5, maze5_fmsl, maze4_fmsl and main (a
    rich dict, 3 GRU layers) from tests/torch_ref_nets.py with random weights
    and BN statistics: converted with no missing or unconsumed key, scored by
    ``cli.evaluate --model_path``, the scores within atol 5e-4, rtol 1e-3 of
    the torch reference on the card with TF32 off; K1, K3 and K3-bwd no
    launch. The CLI's f32 model runs its trunk's convs in cuDNN's default
    TF32 (only the sinc conv opts out); the same checkpoint's in-process
    scores with TF32 off give the gap beside it. (b) main's
    converted ``experiment.yaml`` with ``fused_train_frontend`` and batch 12:
    ``cli.train --restore --eval`` scores the restored weights equal to (a)'s
    file, then ``cli.train --restore`` trains one epoch, K3 and K3-bwd
    ('3xtf32': the model is f32) once a step, finite losses; from the
    converted weights and one batch, randomness off, a fused step against the
    composition: loss within 5e-2 relative, gradient cosine >= 0.85. (c) maze5
    with 'reference' block semantics in bf16 and ``fused_eval_trunk``: no K1
    launch, scores bitwise those of the same model without the flag."""
    import dataclasses

    from adfmsl_torch.cli import convert_maze, evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.config import load_yaml, make_experiment, save_yaml
    from adfmsl_torch.data import SyntheticSpec, generate_fixture
    from adfmsl_torch.models import build_model, load_checkpoint
    from adfmsl_torch.train import CheckpointManager, Optimizer, TrainState, make_train_step

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_ref_nets as nets

    root = os.path.join(tmp, "reference_ckpt")
    fixture = generate_fixture(root, SyntheticSpec(n_train=REF_TRAIN_UTTS, n_dev=REF_DEV_UTTS,
                                                   n_eval=REF_EVAL_UTTS))
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]

    k5_base = [k5_launches()]

    def counts():
        return {"k1": rf.resblock_eval.launches, "k3": sf.sinc_abs_pool_fused.launches,
                "k3_bwd": sf.sinc_abs_pool_bwd.launches, "k5": k5_launches() - k5_base[0]}

    def zero():
        rf.resblock_eval.launches = sf.sinc_abs_pool_fused.launches = 0
        sf.sinc_abs_pool_bwd.launches = 0
        k5_base[0] = k5_launches()

    # (a)
    recs, converted, audio_cache = [], {}, {}
    t_a = time.perf_counter()
    for seed, name in enumerate(REF_CKPT_MODELS):
        t0 = time.perf_counter()
        tm = nets.randomize(_ref_net(name, nets), torch.Generator().manual_seed(seed)).eval()
        pth, ck = os.path.join(root, f"{name}.pth"), os.path.join(root, f"{name}_ck")
        sd = tm.state_dict()
        torch.save({"model_state_dict": sd, "epoch": 3} if name == "main" else sd, pth)
        zero()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = convert_maze.main(["--torch_ckpt", pth, "--model_type", name, "--out", ck,
                                    "--cut", str(CUT), "--device", dev.type])
        check(rc == 0, f"reference_ckpt (a) {name}: convert_maze exited {rc}")
        check("[missing=0 unconsumed=0]" in buf.getvalue(),
              f"reference_ckpt (a) {name}: conversion reported {buf.getvalue()!r}")
        out = os.path.join(root, f"{name}_scores.txt")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = evaluate.main(["--model_type", name, "--model_path", ck, "--protocol",
                                ev["protocol"], "--data_dir", ev["audio_dir"], "--output", out,
                                "--batch_size", str(EVAL_BATCH), "--device", dev.type])
        torch.cuda.synchronize()
        launched = counts()
        check(rc == 0, f"reference_ckpt (a) {name}: evaluate exited {rc}")
        check(launched == {"k1": 0, "k3": 0, "k3_bwd": 0, "k5": 0},
              f"reference_ckpt (a) {name}: kernels launched {launched}")
        got = _score_file(out, ev["utt_ids"])
        exp, port_sd = load_checkpoint(ck)
        audio = _fixture_audio(load_yaml(os.path.join(ck, "experiment.yaml")), ev)
        audio_cache[name] = audio
        tm.to(dev)
        with exact_f32():
            ref = _batched_scores(lambda x: tm(x)[:, 1], audio, dev)
        del tm
        model = build_model(exp.model, device=dev)
        model.load_state_dict(port_sd, strict=True)
        with exact_f32():
            tf32_off = _batched_scores(lambda x: model(x)["scores"], audio, dev)
        del model
        converted[name] = port_sd
        gap = float(np.abs(got - ref).max())
        excess = float(np.max(np.abs(got - ref) - REF_SCORE_RTOL * np.abs(ref)))
        rec = {"model": name, "utterances": len(got), "batch": EVAL_BATCH, "cut": CUT,
               "max_abs_score_diff": gap, "atol": REF_SCORE_ATOL, "rtol": REF_SCORE_RTOL,
               "max_diff_less_rtol_term": excess,
               "tf32_off_max_abs_diff": float(np.abs(tf32_off - ref).max()),
               "max_abs_ref_score": float(np.abs(ref).max()),
               "launches": launched, "seconds": time.perf_counter() - t0}
        recs.append(rec)
        check(bool(np.isfinite(got).all()) and
              bool(np.allclose(got, ref, atol=REF_SCORE_ATOL, rtol=REF_SCORE_RTOL)),
              f"reference_ckpt (a) {name}: scores {gap} from the torch reference")
    rec_a = {"models": recs, "seconds": time.perf_counter() - t_a, "card": card}
    print("reference_ckpt_a " + json.dumps(rec_a), flush=True)

    # (b)
    t_b = time.perf_counter()
    ck = os.path.join(root, "main_ck")
    y = load_yaml(os.path.join(ck, "experiment.yaml"))
    y.model.extra.update(K3_TRAIN)
    y.train.batch_size, y.train.eval_batch_size = TRAIN_BATCH, EVAL_BATCH
    cfg = os.path.join(root, "main_finetune.yaml")
    save_yaml(y, cfg)
    data = ["--config", cfg, "--train_protocol", tr["protocol"], "--train_dir", tr["audio_dir"],
            "--checkpoint_dir", ck, "--restore", "--device", dev.type]
    restored = os.path.join(root, "main_restored_scores.txt")
    zero()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_train.main([*data, "--eval", "--eval_protocol", ev["protocol"], "--eval_dir",
                             ev["audio_dir"], "--eval_output", restored])
    torch.cuda.synchronize()
    check(rc == 0, f"reference_ckpt (b): cli.train --restore --eval exited {rc}")
    eval_launched = counts()
    check(eval_launched["k3"] == 0, f"reference_ckpt (b): --eval launched {eval_launched}")
    before = _score_file(restored, ev["utt_ids"])
    first = _score_file(os.path.join(root, "main_scores.txt"), ev["utt_ids"])
    restore_diff = float(np.abs(before - first).max())
    check(np.array_equal(before, first),
          f"reference_ckpt (b): restored scores {restore_diff} from the converted ones")
    zero()
    t0 = time.perf_counter()
    rc = cli_train.main([*data, "--dev_protocol", dv["protocol"], "--dev_dir", dv["audio_dir"],
                         "--num_epochs", "2"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = counts()
    check(rc == 0, f"reference_ckpt (b): cli.train --restore exited {rc}")
    steps = REF_TRAIN_UTTS // TRAIN_BATCH
    check(launched["k3"] == steps and launched["k3_bwd"] == steps and launched["k1"] == 0,
          f"reference_ckpt (b): {launched} launches in {steps} fine-tuning steps")
    mgr = CheckpointManager(ck)
    check(mgr.all_epochs()[-1] == 1, f"reference_ckpt (b): epochs {mgr.all_epochs()}")
    metrics = mgr.metrics(1)
    check(math.isfinite(metrics["train_loss"]), f"reference_ckpt (b): epoch 1 {metrics}")

    e = load_yaml(cfg)
    e.model.architecture.dropout_rate = e.model.architecture.fc_dropout = 0.0
    e.model.spec_augment.enabled = False
    x = _fixture_audio(e, tr, TRAIN_BATCH).to(dev)
    labels = (torch.arange(TRAIN_BATCH, device=dev) % 2).long()
    mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
    loss, grads, step_launches = {}, {}, {}
    for key, extra in (("k3", K3_TRAIN), ("composition", {})):
        ek = dataclasses.replace(e, model=dataclasses.replace(e.model, extra=dict(extra)))
        model = build_model(ek.model, device=dev)
        model.load_state_dict(converted["main"], strict=True)
        st = TrainState(model, Optimizer(ek.train.optimizer, model.parameters(), 10, 1), seed=0)
        zero()
        met = make_train_step(ek)(st, x, labels, mask, st.generators(0, 0))
        torch.cuda.synchronize()
        step_launches[key] = counts()
        check(float(met["skipped"]) == 0.0, f"reference_ckpt (b): {key} step skipped")
        loss[key], grads[key] = float(met["loss"]), _grads(st, met)
        del model, st
    check(step_launches["k3"]["k3"] == 1 and step_launches["k3"]["k3_bwd"] == 1
          and step_launches["composition"]["k3"] == 0,
          f"reference_ckpt (b): step launches {step_launches}")
    a = np.concatenate(list(grads["k3"].values()))
    b = np.concatenate([grads["composition"][k] for k in grads["k3"]])
    cos = float(a @ b) / float(np.linalg.norm(a) * np.linalg.norm(b))
    rel = abs(loss["k3"] - loss["composition"]) / abs(loss["composition"])
    rec_b = {"model": "main", "config": "converted experiment.yaml + fused_train_frontend",
             "batch": TRAIN_BATCH, "cut": CUT, "steps": steps, "launches": launched,
             "restored_vs_converted_max_abs_diff": restore_diff,
             "epoch1": metrics, "train_s": train_s,
             "loss_k3": loss["k3"], "loss_composition": loss["composition"],
             "loss_rel_diff": rel, "loss_tol": FUSED_TRAIN_LOSS_REL,
             "grad_cosine": cos, "grad_cosine_min": FUSED_TRAIN_GRAD_COS,
             "seconds": time.perf_counter() - t_b, "card": card}
    print("reference_ckpt_b " + json.dumps(rec_b), flush=True)
    check(math.isfinite(rel) and rel <= FUSED_TRAIN_LOSS_REL,
          f"reference_ckpt (b): fused step loss differs by {rel}")
    check(math.isfinite(cos) and cos >= FUSED_TRAIN_GRAD_COS,
          f"reference_ckpt (b): fused step gradient cosine {cos}")

    # (c)
    t_c = time.perf_counter()
    scores = {}
    state = None
    for fused in (True, False):
        ec = make_experiment("maze5")
        ec.model.architecture.block_semantics = "reference"
        ec.model.dtype = "bfloat16"
        ec.model.extra["fused_eval_trunk"] = fused
        model = build_model(ec.model, device=dev, seed=0)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state, strict=True)
        zero()
        with torch.no_grad():
            scores[fused] = model(audio_cache["maze5"].to(dev))["scores"]
        torch.cuda.synchronize()
        if fused:
            k1_fused = counts()["k1"]
        del model
    rec_c = {"model": "maze5", "block_semantics": "reference", "dtype": "bfloat16",
             "batch": len(scores[True]), "k1_launches_fused_eval_trunk": k1_fused,
             "scores_bitwise_equal": bool(torch.equal(scores[True], scores[False])),
             "seconds": time.perf_counter() - t_c, "card": card}
    print("reference_ckpt_c " + json.dumps(rec_c), flush=True)
    check(k1_fused == 0, f"reference_ckpt (c): K1 launched {k1_fused} times")
    check(rec_c["scores_bitwise_equal"] and bool(torch.isfinite(scores[True]).all()),
          "reference_ckpt (c): scores differ with fused_eval_trunk")
    torch.cuda.empty_cache()
    return {"a": rec_a, "b": rec_b, "c": rec_c}


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


def phase_remat(name, batch, extra, encoder, sf, rf, dev, card):
    """One train step plain and one with activation checkpointing, from the
    same weights, batch and generators, then their timed steps and peak
    memory. ``encoder``: the Wav2Vec2 encoder's ``remat_layers`` and
    ``remat_extractor``; else ``train.remat`` (the whole forward, as adfmsl).
    The kernels' counts are set to 0 just before each variant's first step
    and read just after it: K1 never launches in training; K3 and its
    backward kernel launch once each a plain step of the fused front end, and
    K3 twice a remat step (the forward, then its recompute)."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import Optimizer, TrainState, make_train_step

    t0 = time.perf_counter()
    exp = make_experiment(name)
    exp.model.extra.update(extra)
    model = build_model(exp.model, device=dev, seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(9)
    args = (0.1 * torch.randn((batch, CUT), generator=g, device=dev),
            (torch.arange(batch, device=dev) % 2).long(),
            torch.ones(batch, dtype=torch.bool, device=dev))
    rec = {"model": name, "card": card, "batch": batch, "cut": CUT, "extra": extra,
           "checkpointed": ("wav2vec2 remat_layers + remat_extractor" if encoder
                            else "train.remat (the whole forward)")}
    steps = {}
    for variant in ("plain", "remat"):
        on = variant == "remat"
        e = make_experiment(name)
        e.model.extra.update(extra)
        if encoder:
            model.wav2vec2.remat_layers = model.wav2vec2.remat_extractor = on
        else:
            e.train.remat = on
        model.load_state_dict(init)
        st = TrainState(model, Optimizer.for_model(e, model, 100, 5), seed=0)
        step = make_train_step(e)
        gens = st.generators(0, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        rf.resblock_eval.launches = 0
        sf.sinc_abs_pool_fused.launches = sf.sinc_abs_pool_bwd.launches = 0
        met = step(st, *args, gens)
        torch.cuda.synchronize()
        launches = {"k1": rf.resblock_eval.launches, "k3": sf.sinc_abs_pool_fused.launches,
                    "k3_bwd": sf.sinc_abs_pool_bwd.launches}
        check(float(met["skipped"]) == 0.0 and math.isfinite(float(met["loss"])),
              f"remat ({name}, {variant}): step {met}")
        steps[variant] = _step_record(st, gens, met, dev)
        fused = bool(extra.get("fused_train_frontend"))
        want = {"k1": 0, "k3": (2 if on and not encoder else 1) if fused else 0,
                "k3_bwd": 1 if fused else 0}
        check(launches == want, f"remat ({name}, {variant}): launches {launches}, "
                                f"expected {want}")
        train_rate(step, st, args, 1, WARM_STEPS)
        torch.cuda.reset_peak_memory_stats(dev)
        rate, ms = train_rate(step, st, args, 1 + WARM_STEPS, TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        rec[variant] = {"launches_first_step": launches, "utt_per_s": rate, "step_ms": ms,
                        "peak_mem_gb": peak / 1e9,
                        "peak_above_resident_gb": (peak - resident) / 1e9}
        del st, step
    if encoder:
        model.wav2vec2.remat_layers = model.wav2vec2.remat_extractor = False
    rec.update(_compare_steps(name, steps["plain"], steps["remat"]))
    rec["seconds"] = time.perf_counter() - t0
    print("remat " + json.dumps(rec), flush=True)
    del model, init, args
    torch.cuda.empty_cache()
    return rec


# the few-shot CLI runs in a subprocess: this driver imports the CLI beside
# chip_smoke.py, counts K1 around the run (the count starts at 0 in the new
# process and is set to 0 again just before), times the meta steps and the
# scoring, and then, from the same trained weights, adapts and scores again
# with the trunk unfolded
FEWSHOT_DRIVER = r'''
import json, sys, time
root, argv = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import torch
from adfmsl_torch.cli import fewshot
from adfmsl_torch.ops import resblock_fused as rf
from adfmsl_torch.train import fewshot as fs

seen, rec = {}, {}
init, adapt, score_protocol = (fs.FewshotTrainer.__init__, fs.FewshotTrainer.adapt,
                               fs.FewshotTrainer.score_protocol)

def traced_init(self, *a, **k):
    init(self, *a, **k)
    seen["trainer"] = self

def traced_adapt(self, audio, labels, n_classes=2):
    seen["support"] = (audio, labels)
    return adapt(self, audio, labels, n_classes)

def traced_score(self, ds, protos, batch_size=32):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = score_protocol(self, ds, protos, batch_size)
    torch.cuda.synchronize()
    seen["dataset"] = ds
    rec["score_s"], rec["scored"] = time.perf_counter() - t0, len(out)
    return out

fs.FewshotTrainer.__init__ = traced_init
fs.FewshotTrainer.adapt = traced_adapt
fs.FewshotTrainer.score_protocol = traced_score
rf.resblock_eval.launches = 0
rec["rc"] = fewshot.main(argv)
torch.cuda.synchronize()
rec["k1_launches"] = rf.resblock_eval.launches
tr = seen["trainer"]
rec["history"] = tr.history
rec["fused_trunk"] = any(getattr(m, "fused_eval", False) for m in tr.model.modules())
for m in tr.model.modules():
    if hasattr(m, "fused_eval"):
        m.fused_eval = False
protos = adapt(tr, *seen["support"])
rf.resblock_eval.launches = 0
rec["unfolded_scores"] = score_protocol(tr, seen["dataset"], protos)
rec["unfolded_k1_launches"] = rf.resblock_eval.launches
print("fewshot_driver " + json.dumps(rec), flush=True)
'''


def phase_fewshot(rf, tmp, card):
    """``python -m adfmsl_torch.cli.fewshot --model maze5`` in a subprocess on
    the card (``FEWSHOT_DRIVER``), at cut 64600 and the CLI's default episode
    shape (2-way, 5-shot, 5 queries, 4 episodes: 80 utterances a meta step),
    3 meta steps on a 64-utterance train fixture (its spoofs are A02 / A04 /
    A06, at least 10 a class), adapted to and scoring the 40-utterance
    'wild' fixture; then again with ``--no_fused_trunk``. Checks: the score
    file holds every wild utterance but the 10 support ones, in protocol
    order, finite; the EER printed; K1 5 times a maze5 eval forward (the
    adaptation's and each scoring batch's) with the folded trunk and never
    without it; the fused run's scores against the unfolded trunk's from the
    same trained weights within 3e-2 * max(1, |score|) (tests/test_pallas.py's
    bf16 tolerance). The second run's scores beside the first's are recorded
    (its meta-training is a second run on the card)."""
    from adfmsl_torch.data import SyntheticSpec, generate_fixture, generate_wild_fixture

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "fewshot")
    fx = generate_fixture(root, SyntheticSpec(n_train=FEWSHOT_TRAIN_UTTS, n_dev=2, n_eval=2))
    wild = generate_wild_fixture(os.path.join(root, "wild"),
                                 SyntheticSpec(n_eval=FEWSHOT_WILD_UTTS))["eval"]
    n_support = 2 * FEWSHOT_K_SHOT
    forwards = 1 + -(-FEWSHOT_WILD_UTTS // FEWSHOT_SCORE_BATCH)
    rec = {"model": "maze5", "card": card, "cut": CUT, "meta_steps": FEWSHOT_STEPS,
           "utterances_a_meta_step": FEWSHOT_UTTS_A_STEP, "train_utterances":
           FEWSHOT_TRAIN_UTTS, "wild_utterances": FEWSHOT_WILD_UTTS}
    scores = {}
    for label, flags in (("fused", []), ("unfused", ["--no_fused_trunk"])):
        out = os.path.join(root, f"{label}_scores.txt")
        argv = ["--model", "maze5", "--train_protocol", fx["train"]["protocol"],
                "--train_dir", fx["train"]["audio_dir"], "--adapt_protocol", wild["protocol"],
                "--adapt_dir", wild["audio_dir"], "--n_steps", str(FEWSHOT_STEPS),
                "--cut", str(CUT), "--output", out, "--device", "cuda", *flags]
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", FEWSHOT_DRIVER, str(ROOT), json.dumps(argv)],
                           capture_output=True, text=True, timeout=900)
        wall_s = time.perf_counter() - t0
        check(p.returncode == 0, f"fewshot ({label}): exited {p.returncode}: "
                                 f"{p.stderr[-3000:]}")
        lines = p.stdout.splitlines()
        drv = json.loads(next(ln for ln in lines if ln.startswith("fewshot_driver "))
                         .split(" ", 1)[1])
        metrics = [ast.literal_eval(ln) for ln in lines if ln.startswith("{")]
        check(drv["rc"] == 0 and bool(metrics) and "eer" in metrics[-1],
              f"fewshot ({label}): no EER printed: {p.stdout[-2000:]}")
        check(metrics[-1]["n_support_excluded"] == n_support,
              f"fewshot ({label}): {metrics[-1]}")
        hist = drv["history"][:FEWSHOT_STEPS]
        check(len(hist) == FEWSHOT_STEPS and all(math.isfinite(h["loss"]) for h in hist),
              f"fewshot ({label}): meta steps {hist}")
        with open(out) as fh:
            rows = [ln.split() for ln in fh.read().splitlines()]
        ids = [r[0] for r in rows]
        scores[label] = {r[0]: float(r[1]) for r in rows}
        check(len(ids) == FEWSHOT_WILD_UTTS - n_support
              and ids == [u for u in wild["utt_ids"] if u in scores[label]],
              f"fewshot ({label}): score file ids")
        check(all(math.isfinite(v) for v in scores[label].values()),
              f"fewshot ({label}): non-finite scores")
        want_k1 = K1_MAZE5 * forwards if label == "fused" else 0
        check(drv["k1_launches"] == want_k1 and drv["fused_trunk"] == (label == "fused"),
              f"fewshot ({label}): K1 launched {drv['k1_launches']} times, expected {want_k1}")
        run = {"wall_s": wall_s, "k1_launches": drv["k1_launches"],
               "meta_step_s": [h["seconds"] for h in hist],
               "meta_step_ms_median_after_first": 1e3 * float(np.median(
                   [h["seconds"] for h in hist[1:]])),
               "losses": [h["loss"] for h in hist], "score_s": drv["score_s"],
               "scored_utterances": drv["scored"],
               "score_utt_per_s": drv["scored"] / drv["score_s"],
               "eer": metrics[-1]["eer"]}
        if label == "fused":
            ref = np.asarray([drv["unfolded_scores"][u] for u in ids])
            got = np.asarray([scores[label][u] for u in ids])
            err = float(np.abs(got - ref).max())
            tol = FEWSHOT_SCORE_TOL * max(1.0, float(np.abs(ref).max()))
            check(drv["unfolded_k1_launches"] == 0 and err <= tol,
                  f"fewshot: folded vs unfolded scores {err} > {tol}")
            run.update(folded_vs_unfolded_max_abs_err=err, folded_vs_unfolded_tol=tol)
        rec[label] = run
    both = [u for u in scores["fused"]]
    rec["cli_runs_max_abs_score_diff"] = float(max(
        abs(scores["fused"][u] - scores["unfused"][u]) for u in both))
    rec["seconds"] = time.perf_counter() - t_phase
    print("fewshot " + json.dumps(rec), flush=True)
    return rec


@contextlib.contextmanager
def exact_f32():
    """TF32 off in cuDNN and cuBLAS for the block: f32 products stay f32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def md_experiment(name, deterministic=False, extra=None):
    """``name``'s configuration; ``deterministic``: f32 with the randomness off."""
    from adfmsl_torch.config import make_experiment

    exp = make_experiment(name)
    exp.model.extra.update(extra or {})
    if deterministic:
        exp.model.architecture.dropout_rate = exp.model.architecture.fc_dropout = 0.0
        exp.model.spec_augment.enabled = False
        if exp.model.fmsl is not None:
            exp.model.fmsl.proj_dropout, exp.model.fmsl.enable_lsa = 0.0, False
    return exp


def md_state(exp, dev, sd=None, seed=0):
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import Optimizer, TrainState

    model = build_model(exp.model, device=dev, seed=seed)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return TrainState(model, Optimizer.for_model(exp, model, 10), seed=0)


def md_host_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def md_step_ms(step, st, args_fn, n=TIMED_STEPS, warm=WARM_STEPS):
    """Host-clock ms of ``n`` steps after ``warm`` ones, ending in a sync."""
    for i in range(warm):
        step(st, *args_fn(1 + i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(st, *args_fn(1 + warm + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def md_world_one(dev):
    """(a): a world of one over NCCL. maze5's data-parallel step (its
    collectives the identity) against two plain steps from the same weights,
    batch and generators; then each step's ms."""
    from adfmsl_torch.config import MeshConfig
    from adfmsl_torch.parallel import make_mesh, replicate
    from adfmsl_torch.train import make_train_step

    mesh = make_mesh(MeshConfig())
    exp = md_experiment("maze5")
    g = torch.Generator(device=dev).manual_seed(21)
    x = 0.1 * torch.randn((MD_BATCH, CUT), generator=g, device=dev)
    y = (torch.arange(MD_BATCH, device=dev) % 2).long()
    m = torch.ones(MD_BATCH, dtype=torch.bool, device=dev)
    rec, states = {"model": "maze5", "batch": MD_BATCH, "backend": "nccl", "world": 1}, {}
    for label, step_mesh in (("plain", None), ("plain_again", None), ("dp", mesh)):
        st = md_state(exp, dev)
        if step_mesh is not None:
            replicate(mesh, st.model)
        step = make_train_step(exp, step_mesh)
        met = step(st, x, y, m, st.generators(0, 0))
        states[label] = (float(met["loss"]), md_host_state(st.model))
        if label != "plain_again":
            rec[f"{label}_step_ms"] = md_step_ms(step, st,
                                                 lambda i: (x, y, m, st.generators(0, i)))
        del st, step
        torch.cuda.empty_cache()
    plain, again, dp = (states[k] for k in ("plain", "plain_again", "dp"))
    rec["loss"] = {"plain": plain[0], "plain_again": again[0], "dp": dp[0]}
    floats = [k for k, v in plain[1].items() if v.is_floating_point()]
    rec["plain_steps_bitwise_equal"] = all(torch.equal(plain[1][k], again[1][k])
                                           for k in floats)
    diff = [int((plain[1][k] != dp[1][k]).sum()) for k in floats]
    rec["elements_differing_from_plain"] = sum(diff)
    lr = exp.train.optimizer.lr
    rec["max_abs_param_diff"] = max(float((plain[1][k] - dp[1][k]).abs().max())
                                    for k in floats)
    rec["bound"] = ("bitwise" if rec["plain_steps_bitwise_equal"]
                    else f"Adam's first-step flip, 2.1 * lr = {2.1 * lr}")
    rec["ok"] = (plain[0] == dp[0] and (rec["elements_differing_from_plain"] == 0
                                        if rec["plain_steps_bitwise_equal"]
                                        else rec["max_abs_param_diff"] <= 2.1 * lr))
    return rec


def md_two_ranks(dev, sd5, batches, sd_main, xd, yd):
    """(c), (d) and (e) on two gloo ranks sharing the card."""
    from adfmsl_torch.config import MeshConfig
    from adfmsl_torch.parallel import (check_replicated, kernel_launches, make_mesh,
                                       replicate, reset_kernel_launches, shard_batch)
    from adfmsl_torch.parallel.tp import shard_params_tp
    from adfmsl_torch.train import make_train_step

    mesh = make_mesh(MeshConfig())
    out = {"rank": mesh.rank}
    # (c) maze5, f32, randomness and TF32 off, 3 steps on 3 global batches
    with exact_f32():
        exp = md_experiment("maze5", deterministic=True)
        exp.model.dtype = "float32"
        st = md_state(exp, dev, sd5)
        replicate(mesh, st.model)
        step = make_train_step(exp, mesh)
        losses, times = [], []
        for i, (x, y) in enumerate(batches):
            xs, ys = shard_batch(mesh, [x.to(dev), y.to(dev)])
            m = torch.ones(len(xs), dtype=torch.bool, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(st, xs, ys, m, st.generators(0, i, mesh.data_rank))
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads = _grads(st, met)
        check_replicated(st.model)
        out["c"] = {"losses": losses, "step_ms": times, "grads": grads,
                    "state": md_host_state(st.model)}
        del st, step
    # (d) RawNet main, K3 in the train forward, 2 steps on one global batch
    exp = md_experiment("main", deterministic=True, extra=K3_TRAIN)
    st = md_state(exp, dev, sd_main)
    replicate(mesh, st.model)
    step = make_train_step(exp, mesh)
    xs, ys = shard_batch(mesh, [xd.to(dev), yd.to(dev)])
    m = torch.ones(len(xs), dtype=torch.bool, device=dev)
    reset_kernel_launches()
    losses, times = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(st, xs, ys, m, st.generators(0, i, mesh.data_rank))
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = _grads(st, met)
    torch.cuda.synchronize()
    out["d"] = {"losses": losses, "step_ms": times, "grads": grads,
                "launches": kernel_launches()}
    del st, step
    # (d)'s second witness: the same step in f32 with TF32 off (K3's backward
    # kernel at '3xtf32'), one step
    with exact_f32():
        exp = md_experiment("main", deterministic=True, extra=K3_TRAIN)
        exp.model.dtype = "float32"
        st = md_state(exp, dev, sd_main)
        replicate(mesh, st.model)
        met = make_train_step(exp, mesh)(st, xs, ys, m, st.generators(0, 0, mesh.data_rank))
        out["d_f32"] = {"loss": float(met["loss"]), "grads": _grads(st, met)}
        del st
    torch.cuda.empty_cache()
    # (e) maze7 (the base encoder, bf16): tensor-parallel against replicated
    exp = md_experiment("maze7")
    from adfmsl_torch.models import build_model

    model = build_model(exp.model, device=dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(8)
    x = 0.1 * torch.randn((MD_TP_BATCH, CUT), generator=g, device=dev)
    heads = model.wav2vec2.layers_0.attention.heads
    ffn = model.wav2vec2.layers_0.intermediate_dense.weight.shape[0]
    with torch.no_grad():
        ref = model(x)["logits"].float()
        ref_ms = cuda_ms(lambda: model(x), reps=3, warm=1, runs=1)
        shard_params_tp(model, make_mesh(MeshConfig(model_parallel=2)))
        tp = model(x)["logits"].float()
        tp_ms = cuda_ms(lambda: model(x), reps=3, warm=1, runs=1)
    out["e"] = {"heads": [heads, model.wav2vec2.layers_0.attention.heads],
                "ffn": [ffn, model.wav2vec2.layers_0.intermediate_dense.weight.shape[0]],
                "max_abs_err": float((tp - ref).abs().max()),
                "tol": 3e-2 * max(1.0, float(ref.abs().max())),
                "replicated_ms": ref_ms, "tp_ms": tp_ms}
    return out


def phase_multidevice(fixture, tmp, dev, card):
    """Phase 7e (see the module docstring): the port's multi-device paths on
    the one card, (a) a world of one over NCCL, (b)-(e) two gloo ranks."""
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.parallel import launch
    from adfmsl_torch.train import make_train_step

    t_phase = time.perf_counter()
    rec = {"card": card, "note_two_rank_times": MD_SHARED}
    # (a)
    (a,) = launch(md_world_one, 1, backend="nccl", timeout=MD_LIMIT)
    rec["a_world_one_nccl"] = a
    check(a["ok"], f"multidevice (a): the one-rank step differs from the plain step: {a}")
    # (b) the evaluate CLI on two ranks against one process
    ev = fixture["eval"]
    base = ["--model_type", "maze5", "--protocol", ev["protocol"], "--data_dir",
            ev["audio_dir"], "--batch_size", str(BENCH_BATCH), "--cut", str(CUT),
            "--device", dev.type]
    one, two = os.path.join(tmp, "md_one.txt"), os.path.join(tmp, "md_two.txt")
    check(evaluate.main(base + ["--output", one]) == 0, "multidevice (b): one-process CLI")
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "adfmsl_torch.cli.evaluate", *base,
                          "--output", two, "--data_parallel", "2", "--dist_backend", "gloo",
                          "--dist_timeout", str(MD_LIMIT)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         cwd=str(ROOT), start_new_session=True)
    try:
        stdout, stderr = p.communicate(timeout=MD_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)      # the CLI and the ranks it spawned
        p.communicate()
        raise
    cli_s = time.perf_counter() - t0
    check(p.returncode == 0, f"multidevice (b): CLI exited {p.returncode}: {stderr[-3000:]}")
    ranks = sorted((json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
                    if ln.startswith("rank_summary ")), key=lambda r: r["rank"])
    rows = {}
    for label, path in (("one", one), ("two", two)):
        with open(path) as fh:
            rows[label] = [ln.split() for ln in fh.read().splitlines()]
    ids = [r[0] for r in rows["two"]]
    got = np.asarray([float(r[1]) for r in rows["two"]])
    ref = np.asarray([float(r[1]) for r in rows["one"]])
    err = float(np.abs(got - ref).max())
    tol = MD_SCORE_REL * max(1.0, float(np.abs(ref).max()))
    batches = -(-len(ev["utt_ids"]) // BENCH_BATCH)
    k1 = [r["kernel_launches"]["K1"] for r in ranks]
    rec["b_evaluate_cli_two_gloo_ranks"] = {
        "model": "maze5", "batch": BENCH_BATCH, "utterances": len(ids),
        "max_abs_score_diff": err, "tol": tol, "k1_launches_by_rank": k1,
        "cli_wall_s": cli_s}
    check(ids == [r[0] for r in rows["one"]] == ev["utt_ids"], "multidevice (b): score ids")
    check(np.isfinite(got).all() and err <= tol, f"multidevice (b): scores {err} > {tol}")
    check(len(ranks) == 2 and k1 == [K1_MAZE5 * batches] * 2,
          f"multidevice (b): K1 launches by rank {k1}, expected {K1_MAZE5 * batches} each")
    # the one-process references of (c) and (d)
    g = torch.Generator().manual_seed(31)
    mk = [(0.1 * torch.randn((MD_BATCH, CUT), generator=g),
           torch.tensor([0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1])[torch.randperm(MD_BATCH,
                                                                            generator=g)])
          for _ in range(MD_STEPS)]
    with exact_f32():
        exp = md_experiment("maze5", deterministic=True)
        exp.model.dtype = "float32"
        st = md_state(exp, dev)
        sd5 = md_host_state(st.model)
        step = make_train_step(exp)
        ref_losses = []
        for i, (x, y) in enumerate(mk):
            met = step(st, x.to(dev), y.to(dev), torch.ones(MD_BATCH, dtype=torch.bool,
                                                            device=dev), st.generators(0, i))
            ref_losses.append(float(met["loss"]))
            if i == 0:
                ref_grads5 = _grads(st, met)
        post5 = md_host_state(st.model)
        del st, step
    exp = md_experiment("main", deterministic=True, extra=K3_TRAIN)
    st = md_state(exp, dev)
    sd_main = md_host_state(st.model)
    xd = 0.1 * torch.randn((MD_BATCH, CUT), generator=g)
    yd = (torch.arange(MD_BATCH) % 2).long()
    met = make_train_step(exp)(st, xd.to(dev), yd.to(dev),
                               torch.ones(MD_BATCH, dtype=torch.bool, device=dev),
                               st.generators(0, 0))
    ref_main = (float(met["loss"]), _grads(st, met))
    del st
    with exact_f32():
        exp.model.dtype = "float32"
        st = md_state(exp, dev, sd_main)
        met = make_train_step(exp)(st, xd.to(dev), yd.to(dev),
                                   torch.ones(MD_BATCH, dtype=torch.bool, device=dev),
                                   st.generators(0, 0))
        ref_main_f32 = (float(met["loss"]), _grads(st, met))
        del st
    torch.cuda.empty_cache()
    # (c), (d), (e) on two ranks
    t0 = time.perf_counter()
    out = launch(md_two_ranks, 2, (sd5, mk, sd_main, xd, yd), backend="gloo",
                 timeout=MD_LIMIT)
    two_s = time.perf_counter() - t0
    c = [o["c"] for o in out]
    floats = [k for k, v in post5.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))]
    du = torch.cat([(c[0]["state"][k] - sd5[k]).double().flatten() for k in floats])
    dr = torch.cat([(post5[k] - sd5[k]).double().flatten() for k in floats])
    cos = float(du @ dr / (du.norm() * dr.norm()))
    ga = np.concatenate(list(c[0]["grads"].values()))
    gb = np.concatenate([ref_grads5[k] for k in c[0]["grads"]])
    gcos5 = float(ga @ gb) / float(np.linalg.norm(ga) * np.linalg.norm(gb))
    rel = [abs(a - b) / abs(b) for a, b in zip(c[0]["losses"], ref_losses)]
    ranks_equal = all(torch.equal(c[0]["state"][k], c[1]["state"][k]) for k in c[0]["state"])
    rec["c_maze5_f32_two_gloo_ranks"] = {
        "global_batch": MD_BATCH, "steps": MD_STEPS, "losses": c[0]["losses"],
        "one_process_losses": ref_losses, "loss_rel_diff": rel, "loss_tol": MD_LOSS_REL,
        "first_step_grad_cosine": gcos5, "grad_cosine_min": MD_GRAD_COS,
        "update_cosine": cos, "update_cosine_min": MD_UPDATE_COS,
        "ranks_bitwise_equal": ranks_equal,
        "step_ms_by_rank": [x["step_ms"] for x in c], "step_ms_note": MD_SHARED}
    check(c[0]["losses"] == c[1]["losses"] and max(rel) <= MD_LOSS_REL,
          f"multidevice (c): losses {c[0]['losses']} against {ref_losses}")
    check(gcos5 >= MD_GRAD_COS and cos >= MD_UPDATE_COS and ranks_equal,
          f"multidevice (c): first-step gradient cosine {gcos5}, update cosine {cos}, "
          f"ranks equal {ranks_equal}")

    def cosine(ga, gb):
        a_ = np.concatenate([ga[k] for k in sorted(ga)])
        b_ = np.concatenate([gb[k] for k in sorted(ga)])
        return float(a_ @ b_) / float(np.linalg.norm(a_) * np.linalg.norm(b_))

    d = [o["d"] for o in out]
    gcos = cosine(d[0]["grads"], ref_main[1])
    lrel = abs(d[0]["losses"][0] - ref_main[0]) / abs(ref_main[0])
    d32 = [o["d_f32"] for o in out]
    gcos32 = cosine(d32[0]["grads"], ref_main_f32[1])
    lrel32 = abs(d32[0]["loss"] - ref_main_f32[0]) / abs(ref_main_f32[0])
    k3 = [x["launches"]["K3"] for x in d]
    k3b = [x["launches"]["K3-bwd"] for x in d]
    rec["d_main_fused_two_gloo_ranks"] = {
        "global_batch": MD_BATCH, "steps": 2, "loss": d[0]["losses"][0],
        "one_process_loss": ref_main[0], "loss_rel_diff": lrel, "loss_tol": MD_BF16_LOSS_REL,
        "grad_cosine": gcos, "grad_cosine_min": MD_BF16_GRAD_COS,
        "f32_witness": {"loss": d32[0]["loss"], "one_process_loss": ref_main_f32[0],
                        "loss_rel_diff": lrel32, "loss_tol": MD_LOSS_REL,
                        "grad_cosine": gcos32, "grad_cosine_min": MD_GRAD_COS,
                        "ranks_equal_loss": d32[0]["loss"] == d32[1]["loss"],
                        "k3_bwd_precision": "3xtf32"},
        "one_process_bf16_vs_f32_grad_cosine": cosine(ref_main[1], ref_main_f32[1]),
        "k3_launches_by_rank": k3, "k3_bwd_launches_by_rank": k3b,
        "step_ms_by_rank": [x["step_ms"] for x in d], "step_ms_note": MD_SHARED}
    check(k3 == [2, 2] and k3b == [2, 2],
          f"multidevice (d): K3 {k3}, K3-bwd {k3b} launches by rank in 2 steps")
    check(lrel <= MD_BF16_LOSS_REL and gcos >= MD_BF16_GRAD_COS,
          f"multidevice (d): loss {lrel}, gradient cosine {gcos}")
    check(lrel32 <= MD_LOSS_REL and gcos32 >= MD_GRAD_COS,
          f"multidevice (d), f32: loss {lrel32}, gradient cosine {gcos32}")
    e = [o["e"] for o in out]
    rec["e_maze7_tensor_parallel_two_gloo_ranks"] = {
        "batch": MD_TP_BATCH, "heads": e[0]["heads"], "ffn": e[0]["ffn"],
        "max_abs_err": max(x["max_abs_err"] for x in e), "tol": e[0]["tol"],
        "replicated_forward_ms_by_rank": [x["replicated_ms"] for x in e],
        "tp_forward_ms_by_rank": [x["tp_ms"] for x in e], "ms_note": MD_SHARED}
    check(e[0]["heads"] == [12, 6] and e[0]["ffn"] == [3072, 1536],
          f"multidevice (e): heads {e[0]['heads']}, FFN {e[0]['ffn']}")
    check(all(x["max_abs_err"] <= x["tol"] for x in e),
          f"multidevice (e): tensor-parallel logits {[x['max_abs_err'] for x in e]}")
    rec["two_rank_launch_s"] = two_s
    rec["seconds"] = time.perf_counter() - t_phase
    print("multidevice " + json.dumps(rec), flush=True)
    return rec


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


def _k6_record(k6):
    """K6's figures at the WavLM cell's shape."""
    return {r["case"]: {**_summed([r]), **{k: r[k] for k in (
        "composition_ms", "roofline_pct", "tflop_per_s", "max_gap_over_bound", "f32_gap",
        "plain_f32_gap")}} for r in k6}


def kernels_phase_line(k1, k3, k3b, k4, k5, k6, figs):
    """The ``kernels_phase`` record of ``--only kernels``: K1 summed over
    maze5's and main's blocks with its figures, K3, K3's backward (both
    precisions), K4, K5 and K6 at their main-path shapes, K3's, K5's and K6's
    build figures."""
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
        "K4_max_err_over_tol": max(r["err_over_tol"] for r in k4),
        **{f"K5_b{r['B']}": {**_summed([r]), "composition_ms": r["composition_ms"],
                             "equal_share": r["equal_share"],
                             "max_gap_over_bound": r["max_gap_over_bound"]} for r in k5},
        "K6": _k6_record(k6)}}


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


def kernels_line(k1, k2, k2_entry, k3, k3b, k3_train, k4, k4_front, k5, k6, main_path,
                 wavlm, native, train, fused_train, remat, fewshot, md, config_cli, ref_ckpt,
                 packs, analysis):
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
    it), times at batch 128, cut 64600, 'high' (batch 384 beside them). The
    few-shot CLI's K1 launches (adaptation and scoring) and the remat phase's
    K3 / K3-bwd launches (a checkpointed fused step and its plain twin) join
    the launches by path, and so do each rank's K1 launches on the evaluate
    CLI's two-rank path and K3's and its backward kernel's in the two-rank
    fused steps (multidevice phase), and the config_cli phase's: K3's and its
    backward kernel's in main's ``--config`` training, K1's in maze5's
    ``cli.train --config --eval`` and in ``cli.evaluate --model_path`` of its
    checkpoint. The reference_ckpt phase's paths: the converted checkpoints
    through ``cli.evaluate`` (no kernel: f32 reference parity) and main's
    fine-tuning from the converted checkpoint (K3, K3-bwd). The packs phase's:
    maze5 scored from a pack (K1), RawNet main trained from packs through the
    train CLI and augmented through the ``Trainer`` (K3, K3-bwd). The analysis
    phase's: maze5 and maze5_fmsl through ``cli.evaluate --dump_embeddings``
    (K1), and ``cli.batch``'s maze5 (K1 on its dev and eval batches) and main
    (K3, K3-bwd in its train steps, K1 on its dev and eval batches). K5: its
    launches on every evaluate path that counts it (once a maze5 batch, none on
    the other models, in training or on the f32 converted checkpoints), its
    largest gap over bound and least bit-for-bit share, and its times at batch
    128 (batch 16 beside them) against the composition it replaced. K6: its
    launches on each rank of the WavLM maze6 evaluate path and in its
    training forward, its gaps and its times at the WavLM cell's shape
    against the composition it replaced."""
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
    # the remat steps (the fused front end's plain step beside them) and the
    # few-shot CLI's adaptation and scoring
    k3_remat = {f"{r['model']} {v} step": r[v]["launches_first_step"]["k3"]
                for r in remat if r["extra"] for v in ("plain", "remat")}
    k3b_remat = {f"{r['model']} {v} step": r[v]["launches_first_step"]["k3_bwd"]
                 for r in remat if r["extra"] for v in ("plain", "remat")}
    k1_fewshot = {"maze5 few-shot CLI (adaptation + scoring)": fewshot["fused"]["k1_launches"]}
    # the multidevice phase's paths, counted in each rank's process
    k1_md = {f"maze5 evaluate CLI --data_parallel 2, rank {r}": n for r, n in
             enumerate(md["b_evaluate_cli_two_gloo_ranks"]["k1_launches_by_rank"])}
    d_md = md["d_main_fused_two_gloo_ranks"]
    k3_md = {f"main fused data-parallel steps x2, rank {r}": n
             for r, n in enumerate(d_md["k3_launches_by_rank"])}
    k3b_md = {f"main fused data-parallel steps x2, rank {r}": n
              for r, n in enumerate(d_md["k3_bwd_launches_by_rank"])}
    cfg_a, cfg_b = config_cli["a"], config_cli["b"]
    k1_cfg = {"maze5 cli.train --config --eval": cfg_b["k1_launches_train_eval"],
              "maze5 cli.evaluate --model_path (experiment.yaml)":
                  cfg_b["k1_launches_evaluate"]}
    k3_cfg = {"main cli.train --config (fused_train_frontend)": cfg_a["k3_launches"]}
    k3b_cfg = {"main cli.train --config (fused_train_frontend)": cfg_a["k3_bwd_launches"]}
    ref_eval = {f"{r['model']} converted reference checkpoint (cli.evaluate)": r["launches"]
                for r in ref_ckpt["a"]["models"]}
    ref_tune = "main converted reference checkpoint fine-tuned (cli.train --restore)"
    k1_ref = {**{k: v["k1"] for k, v in ref_eval.items()},
              "maze5 'reference' blocks, bf16, fused_eval_trunk":
                  ref_ckpt["c"]["k1_launches_fused_eval_trunk"]}
    k3_ref = {**{k: v["k3"] for k, v in ref_eval.items()},
              ref_tune: ref_ckpt["b"]["launches"]["k3"]}
    k3b_ref = {ref_tune: ref_ckpt["b"]["launches"]["k3_bwd"]}
    k1_pack = {"maze5 cli.evaluate --pack": packs["a"]["k1_launches"]}
    k3_pack = {"main cli.train --train_pack --dev_pack (fused_train_frontend)":
                   packs["b"]["k3_launches"],
               "main Trainer from a pack, augmented": packs["c"]["augmented_k3_launches"],
               "main Trainer from a pack, no banks": packs["c"]["plain_k3_launches"]}
    k3b_pack = {"main cli.train --train_pack --dev_pack (fused_train_frontend)":
                    packs["b"]["k3_bwd_launches"],
                "main Trainer from a pack, augmented":
                    packs["c"]["augmented_k3_bwd_launches"],
                "main Trainer from a pack, no banks": packs["c"]["plain_k3_bwd_launches"]}
    batch_k = analysis["c"]["launches"]
    k1_analysis = {**{f"{m} cli.evaluate --dump_embeddings": analysis["a"][m]["k1_launches"]
                      for m in ("maze5", "maze5_fmsl")},
                   **{f"{m} cli.batch (fused_eval_trunk)": batch_k[m]["k1"]
                      for m in ("maze5", "main")}}
    k3_analysis = {"main cli.batch (fused_train_frontend)": batch_k["main"]["k3"]}
    k3b_analysis = {"main cli.batch (fused_train_frontend)": batch_k["main"]["k3_bwd"]}
    k3b_main = {p: _k3_bwd_main(k3b, p) for p in K3_BWD_TOL}
    k3t_main = next(r for r in k3_train if r["B"] == TRAIN_BATCH and r["T"] == CUT)
    k5_main = next(r for r in k5 if r["B"] == BENCH_BATCH)
    k5_small = next(r for r in k5 if r["B"] == EVAL_BATCH)
    k5_paths = {**{r["model"]: r["k5_launches"] for r in main_path},
                **{f"maze5 over the {fmt} eval split": native[f"k5_launches_{fmt}"]
                   for fmt in ("wav", "flac")},
                **{f"{r['model']} trained checkpoint": r["k5_launches_evaluate"]
                   for r in train},
                "maze5 cli.train --config --eval": cfg_b["k5_launches_train_eval"],
                "maze5 cli.evaluate --model_path (experiment.yaml)":
                    cfg_b["k5_launches_evaluate"],
                **{k: v["k5"] for k, v in ref_eval.items()},
                **{f"maze5 cli.evaluate --{k}": n
                   for k, n in packs["a"]["k5_launches"].items()}}
    return {"kernels": [{
        "id": "K1", "name": "resblock_eval", "route": "cuda",
        "source": "adfmsl_torch/csrc/resblock_eval.cu",
        "replaces": "adfmsl/ops/pallas/resblock_fused.py:141",
        "launches": (sum(r["k1_launches"] for r in main_path) + sum(k1_train.values())
                     + sum(k1_fewshot.values()) + sum(k1_md.values())
                     + sum(k1_cfg.values()) + sum(k1_ref.values())
                     + sum(k1_pack.values()) + sum(k1_analysis.values())),
        "launches_by_path": {**{r["model"]: r["k1_launches"] for r in main_path},
                             **k1_train, **k1_fewshot, **k1_md, **k1_cfg, **k1_ref,
                             **k1_pack, **k1_analysis},
        "max_abs_err": max(r["max_abs_err_y"] for r in k1),
        "max_err_over_tol": max(max(r["max_abs_err_y"] / r["tol_y"],
                                    r["max_abs_err_sums"] / r["tol_sums"]) for r in k1),
        **_summed([r for r in k1 if r["case"].startswith("maze5_block")]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the folded block",
        "shapes": f"the five maze5 trunk blocks at batch {BENCH_BATCH}, cut {CUT}",
        "main_blocks": _summed([r for r in k1 if r["case"].startswith("main_block")]),
        **{f"{m}_blocks": {**_summed([r for r in k1 if r["case"].startswith(f"{m}_block")]),
                           "launches_per_forward": next(r["k1_launches"] // r["batches"]
                                                        for r in main_path if r["model"] == m),
                           "shapes": f"batch {BENCH_BATCH}, T 201 frames into the trunk"}
           for m, _ in W2V2_K1_BLOCKS},
        "stack_heads": {f"{r['cin']}->{r['cout']}": {
            **_summed([r]), "shapes": f"{r['case']}: batch {r['B']}, T {r['T']}, 1x1 skip"}
            for r in k1 if r["case"] in ("maze2_block0_b128", "maze6_block0_b128")},
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
                     + sum(k3_fused.values()) + sum(k3_remat.values())
                     + sum(k3_md.values()) + sum(k3_cfg.values()) + sum(k3_ref.values())
                     + sum(k3_pack.values()) + sum(k3_analysis.values())),
        "launches_by_path": {**{r["model"]: r["k3_launches"] for r in main_path},
                             **k3_eval_train, **k3_fused, **k3_remat, **k3_md, **k3_cfg,
                             **k3_ref, **k3_pack, **k3_analysis},
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
        "launches": (sum(k3b_fused.values()) + sum(k3b_remat.values())
                     + sum(k3b_md.values()) + sum(k3b_cfg.values()) + sum(k3b_ref.values())
                     + sum(k3b_pack.values()) + sum(k3b_analysis.values())),
        "launches_by_path": {**k3b_fused, **k3b_remat, **k3b_md, **k3b_cfg, **k3b_ref,
                             **k3b_pack, **k3b_analysis},
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
    }, {
        "id": "K5", "name": "sinc_bn_act", "route": "cuda",
        "source": "adfmsl_torch/csrc/sinc_bn_act.cu",
        "replaces": None,
        "replaces_note": "the port's own kernel: adfmsl leaves maze5's eval front end to XLA",
        "launches": sum(k5_paths.values()),
        "launches_by_path": k5_paths,
        "max_gap_over_bound": max(r["max_gap_over_bound"] for r in k5),
        "min_equal_share": min(r["equal_share"] for r in k5),
        **_summed([k5_main]),
        "library_ms": None,
        "library_note": "no single PyTorch call computes it; plain_ms is the composition "
                        "it replaced (cuDNN's TF32 conv, the bf16 casts, BN, SELU)",
        "shapes": f"batch {BENCH_BATCH}, cut {CUT}, C {SINC_C}, K {SINC_K}",
        f"b{EVAL_BATCH}": _summed([k5_small]),
    }, {
        "id": "K6", "name": "wavlm_attention", "route": "cuda",
        "source": "adfmsl_torch/csrc/wavlm_attention.cu",
        "replaces": None,
        "replaces_note": "the port's own kernel: adfmsl has no WavLM and computes attention "
                         "outside any Pallas kernel",
        "library_ms": None,
        "library_note": "SDPA is no kernel of the port (and refuses an f32 bias under bf16 "
                        "operands); plain_ms is the plain version, composition_ms the "
                        "composition K6 replaced",
        **_k6_record(k6), "wavlm_main_path": {k: wavlm[k] for k in (
            "ranks", "expected_each", "train_forward")},
    }]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels", "k2", "multidevice", "config_cli",
                                       "reference_ckpt", "packs", "analysis", "wavlm"],
                    default=None,
                    help="kernels: only the build and the kernels phase; k2: only "
                         "K2's library and cases; multidevice / config_cli / "
                         "reference_ckpt / packs / analysis / wavlm: only the build and "
                         "that phase (none of them ends in an {\"ok\": ...} line)")
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

    if args.only in ("multidevice", "config_cli", "reference_ckpt", "packs", "analysis",
                     "wavlm"):
        with tempfile.TemporaryDirectory() as tmp:
            if args.only == "reference_ckpt":
                phase("reference_ckpt", phase_reference_ckpt, rf, sf, tmp, dev, smi)
            elif args.only == "analysis":
                phase("analysis", phase_analysis, rf, sf, tmp, smi)
            elif args.only in ("multidevice", "wavlm"):
                fixture = generate_fixture(tmp, SyntheticSpec(n_train=2, n_dev=2,
                                                              n_eval=EVAL_UTTS))
                if args.only == "wavlm":
                    phase("wavlm_main_path", phase_wavlm_main_path, fixture, tmp, dev)
                else:
                    phase("multidevice", phase_multidevice, fixture, tmp, dev, smi)
            else:
                fixture = generate_fixture(tmp, SyntheticSpec(
                    n_train=TRAIN_UTTS, n_dev=DEV_UTTS, n_eval=EVAL_UTTS))
                if args.only == "packs":
                    phase("packs", phase_packs, rf, sf, fixture, tmp, smi)
                else:
                    phase("config_cli", phase_config_cli, rf, sf, fixture, tmp, smi)
        print("phase_seconds " + json.dumps({**phase_s,
                                             "total": time.perf_counter() - t_start}))
        print(smi, flush=True)
        return 0
    k1, k3, k3b, k4, k5, k6, figs = phase("kernels", phase_kernels, rf, sf, lf, dev)
    if args.only == "kernels":
        print("phase_seconds " + json.dumps({**phase_s,
                                             "total": time.perf_counter() - t_start}))
        print(smi, flush=True)
        print(json.dumps(kernels_phase_line(k1, k3, k3b, k4, k5, k6, figs)), flush=True)
        return 0
    k3_train = phase("k3_train", phase_k3_train, sf, dev)
    k2_recs, k2_entry = phase("k2", phase_k2, k2, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = generate_fixture(tmp, SyntheticSpec(n_train=TRAIN_UTTS, n_dev=DEV_UTTS,
                                                      n_eval=EVAL_UTTS))
        main_path = phase("main_path", lambda: [
            phase_main_path(*p, rf, sf, lf, fixture, tmp) for p in MAIN_PATHS])
        main_path += phase("w2v2_main_path", lambda: [
            phase_main_path(*p, rf, sf, lf, fixture, tmp) for p in W2V2_PATHS])
        wavlm = phase("wavlm_main_path", phase_wavlm_main_path, fixture, tmp, dev)
        native = phase("native_io", phase_native_io, rf, fixture, tmp)
        train = phase("train", lambda: [phase_train(n, rf, k2, sf, fixture, tmp, dev)
                                        for n in TRAIN_MODELS])
        train += phase("w2v2_train", lambda: [phase_train(n, rf, k2, sf, fixture, tmp, dev)
                                              for n in W2V2_TRAIN])
        fused_train = phase("fused_train", lambda: [phase_fused_train(n, sf, fixture, dev)
                                                    for n in ("main", "main_fmsl")])
        config_cli = phase("config_cli", phase_config_cli, rf, sf, fixture, tmp, smi)
        ref_ckpt = phase("reference_ckpt", phase_reference_ckpt, rf, sf, tmp, dev, smi)
        packs = phase("packs", phase_packs, rf, sf, fixture, tmp, smi, native)
        analysis = phase("analysis", phase_analysis, rf, sf, tmp, smi)
        remat = phase("remat", lambda: [phase_remat(*c, sf, rf, dev, smi)
                                        for c in REMAT_CASES])
        fewshot = phase("fewshot", phase_fewshot, rf, tmp, smi)
        md = phase("multidevice", phase_multidevice, fixture, tmp, dev, smi)
    phase("folded_vs_unfolded", phase_folded_vs_unfolded, rf, sf, dev)
    k4_front = phase("k4_frontend", phase_k4_frontend, lf, dev, smi)
    phase("train_card_vs_cpu", lambda: [phase_train_card_vs_cpu(n, dev)
                                        for n in ("maze5", "main")])
    print("phase_seconds " + json.dumps({**phase_s,
                                         "total": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps(kernels_line(k1, k2_recs, k2_entry, k3, k3b, k3_train, k4, k4_front, k5,
                                  k6, main_path, wavlm, native, train, fused_train, remat,
                                  fewshot, md, config_cli, ref_ckpt, packs, analysis)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
