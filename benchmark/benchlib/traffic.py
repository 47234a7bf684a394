"""The one traffic generator: utterances, labels and a pack from the seed.

A traffic file gives ``utterances``, the clip length ``cut``, the RMS range
``rms`` (each utterance noise at an RMS drawn log-uniform in it), the
``bonafide_share`` of labels, the ``batch`` and ``prefetch`` of the loader
and its ``driver``. With ``tilt`` each utterance's spectrum is shaped by
(f / 1 kHz)^(a / 2), ``a`` drawn uniform in ``tilt`` (-1 is pink noise, 0
white), so that utterances differ in colour as well as in level. The audio
is drawn on the card from the seed and written once as a pack (adfmsl's format: ``{prefix}.npy`` float32 (N, cut) and
``{prefix}.json``) under ``TMPDIR``; the program's ``PackedDataset`` and the
reference read the same file.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, Tuple

import numpy as np
import torch

SEED_TAG = 0x7A11         # keeps the audio's stream apart from the weights'


def utt_ids(n: int) -> List[str]:
    return [f"LA_B_{i:07d}" for i in range(n)]


def labels(traffic: dict, seed: int) -> np.ndarray:
    """1 (bonafide) for ``bonafide_share`` of the rows, at places drawn from
    the seed; the same count for every seed."""
    n = traffic["utterances"]
    y = np.zeros(n, np.int32)
    k = int(round(traffic.get("bonafide_share", 0.0) * n))
    y[np.random.default_rng([seed, SEED_TAG]).permutation(n)[:k]] = 1
    return y


def audio(traffic: dict, seed: int, device) -> torch.Tensor:
    """(N, cut) float32 on ``device``: coloured noise at a per-utterance RMS."""
    n, cut = traffic["utterances"], traffic["cut"]
    g = torch.Generator(device=device).manual_seed(seed ^ SEED_TAG)
    lo, hi = traffic["rms"]
    rms = torch.exp(torch.empty(n, 1, device=device).uniform_(
        float(np.log(lo)), float(np.log(hi)), generator=g))
    x = torch.randn((n, cut), generator=g, device=device)
    if "tilt" in traffic:
        a = torch.empty(n, 1, device=device).uniform_(*traffic["tilt"], generator=g)
        sr = traffic.get("sample_rate", 16000)
        f = torch.fft.rfftfreq(cut, 1.0 / sr, device=device).clamp(min=20.0)[None, :]
        x = torch.fft.irfft(torch.fft.rfft(x) * (f / 1000.0) ** (a / 2), n=cut)
    return x * (rms / x.pow(2).mean(1, keepdim=True).sqrt())


def write_pack(traffic: dict, seed: int, x: torch.Tensor
               ) -> Tuple[str, tempfile.TemporaryDirectory]:
    """The pack of the seed's traffic ``x`` (``audio``) under ``TMPDIR``:
    (prefix, its directory, which deletes the pack when cleaned up)."""
    tmp = tempfile.TemporaryDirectory(prefix="bench_pack_")
    prefix = os.path.join(tmp.name, "traffic")
    np.save(prefix + ".npy", x.cpu().numpy())
    ids = utt_ids(traffic["utterances"])
    y = labels(traffic, seed)
    with open(prefix + ".json", "w") as fh:
        json.dump({"utt_ids": ids, "cut": traffic["cut"], "pad_mode": "tile",
                   "sample_rate": traffic.get("sample_rate", 16000),
                   "labels": {u: int(v) for u, v in zip(ids, y)}}, fh)
    return prefix, tmp


def read_rows(prefix: str, rows) -> np.ndarray:
    return np.asarray(np.load(prefix + ".npy", mmap_mode="r")[np.asarray(rows)])
