"""Synthetic ASVspoof-style fixture (the port's copy of ``adfmsl/data/synthetic.py``,
with the distribution-shifted 'wild' eval domain of :83-154; the same seed
writes the same files).

The reference has no test fixtures at all (SURVEY.md section 4). This generator builds a
miniature ASVspoof2019-LA-shaped directory — protocol files + WAV audio — where
bonafide/spoof classes are *separable by construction* (bonafide = harmonic tones +
noise, spoof = band-limited noise with a spectral notch), so end-to-end training tests
can assert learning actually happens.

Layout produced (mirrors the LA distribution the reference probes for, maze2.py:254-265):
  root/
    ASVspoof2019_LA_cm_protocols/ASVspoof2019.LA.cm.{train.trn,dev.trl,eval.trl}.txt
    ASVspoof2019_LA_{train,dev,eval}/flac/<utt>.wav   (WAV; '.flac' naming optional)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from adfmsl_torch.data.audio import write_wav

ATTACKS = ["A01", "A02", "A03", "A04", "A05", "A06"]


@dataclass
class SyntheticSpec:
    n_train: int = 24
    n_dev: int = 12
    n_eval: int = 16
    sample_rate: int = 16000
    duration: float = 1.0       # keep fixtures small; pad() tiles to 64600 anyway
    seed: int = 0
    # 1.0 = fully separable classes (default, unchanged RNG stream). Below 1.0
    # both classes share the same tones+noise process and differ only by a
    # class_sep-deep spectral notch on the spoof's noise bed (_hard_pair), so
    # trained models land at a *nonzero* EER — used by the FMSL-vs-baseline
    # quality-claim test (the thesis's central claim needs a fixture where EER
    # deltas are visible, not a saturated 0.0).
    class_sep: float = 1.0


def _bonafide(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    f0 = rng.uniform(110.0, 220.0)
    x = sum(
        rng.uniform(0.2, 0.5) / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 2 * np.pi))
        for k in range(4)
    )
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _spoof(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(freqs > 1000) & (freqs < 3000)] *= 0.05   # spectral notch fingerprint
    spec[freqs > 6000] *= 0.1
    x = np.fft.irfft(spec, n).astype(np.float32)
    return 0.3 * x / (np.abs(x).max() + 1e-9)


def _hard_pair(rng: np.random.Generator, n: int, sr: int, bona: bool,
               sep: float) -> np.ndarray:
    """Hard-mode clip (``class_sep < 1``): BOTH classes are harmonic tones over
    a broadband noise bed; the spoof fingerprint is only a ``sep``-deep
    spectral notch applied to the NOISE component. At sep -> 0 the classes
    coincide (EER -> 0.5); at sep = 1 the notch matches :func:`_spoof`'s.
    Keeps trained EERs off the 0.0 floor so baseline-vs-FMSL deltas are
    visible (tests/test_quality_claim.py)."""
    tone = _bonafide(rng, n, sr)
    bed = rng.standard_normal(n).astype(np.float32)
    if not bona:
        spec = np.fft.rfft(bed)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        spec[(freqs > 1000) & (freqs < 3000)] *= 0.05 ** sep
        spec[freqs > 6000] *= 0.1 ** sep
        bed = np.fft.irfft(spec, n).astype(np.float32)
    return (0.6 * tone + 0.25 * bed).astype(np.float32)


def _wild_channel(rng: np.random.Generator, x: np.ndarray, sr: int) -> np.ndarray:
    """'In-the-wild' transmission chain applied to BOTH classes: mu-law
    companding (lossy-codec analog), a 150-7600 Hz channel band-limit (the
    spectrum outside it scaled by 0.05), 50 Hz mains hum, and pink-ish noise.
    None of these artifacts exist in the lab-domain generator above. Calibrated as a SHIFT, not destruction: the
    class-discriminative cues partially survive (a few in-domain shots can
    re-center the prototypes) while source-domain prototype positions go
    stale — the condition BASELINE config #5 describes."""
    mu = 64.0
    y = np.sign(x) * np.log1p(mu * np.abs(x) / (np.abs(x).max() + 1e-9)) / np.log1p(mu)
    spec = np.fft.rfft(y)
    freqs = np.fft.rfftfreq(len(y), 1.0 / sr)
    spec[(freqs < 150) | (freqs > 7600)] *= 0.05
    y = np.fft.irfft(spec, len(y)).astype(np.float32)
    t = np.arange(len(y)) / sr
    hum = 0.03 * np.sin(2 * np.pi * 50.0 * t + rng.uniform(0, 2 * np.pi))
    pink = np.fft.irfft(
        np.fft.rfft(rng.standard_normal(len(y))) / np.maximum(freqs, 1.0) ** 0.5,
        len(y))
    pink = 0.02 * pink / (np.abs(pink).max() + 1e-9)
    return (y + hum + pink).astype(np.float32)


def _wild_spoof(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Unseen attack family: a 'neural-vocoder' caricature — harmonic voice
    re-synthesised from a coarsely quantised envelope, inter-harmonic metallic
    ringing at 2.7x f0, over a notched noise bed. The bed keeps the attack in
    a cue family the lab embedder can represent (noise-bed presence); the
    quantisation/ring components are new."""
    t = np.arange(n) / sr
    f0 = rng.uniform(110.0, 220.0)
    env = rng.uniform(0.2, 0.5, size=4)
    env = np.round(env * 4) / 4.0                     # quantised envelope
    x = sum(env[k] / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * t
                                      + rng.uniform(0, 2 * np.pi))
            for k in range(4))
    ring = 0.15 * np.sin(2 * np.pi * 2.7 * f0 * t) * np.abs(x)
    bed = _spoof(rng, n, sr)                          # lab-style notched noise
    return (0.7 * x + ring + 0.8 * bed).astype(np.float32)


def generate_wild_fixture(root: str, spec: SyntheticSpec = SyntheticSpec()) -> dict:
    """A distribution-shifted eval-only domain (BASELINE config #5's
    'cross-dataset, unseen-attack' condition): every clip — bonafide harmonic
    voice or :func:`_wild_spoof` attack — passes through :func:`_wild_channel`.
    Same protocol format as :func:`generate_fixture` so the data pipeline is
    reused unchanged."""
    rng = np.random.default_rng(spec.seed + 104729)
    proto_dir = os.path.join(root, "ASVspoof2019_LA_cm_protocols")
    os.makedirs(proto_dir, exist_ok=True)
    n = int(spec.duration * spec.sample_rate)
    audio_dir = os.path.join(root, "ASVspoof2019_LA_eval", "flac")
    os.makedirs(audio_dir, exist_ok=True)
    lines: List[str] = []
    utts = []
    for i in range(spec.n_eval):
        utt = f"LA_W_{i:07d}"
        bona = i % 2 == 0
        ln = n + int(rng.integers(-n // 4, n // 4))
        x = (_bonafide(rng, ln, spec.sample_rate) if bona
             else _wild_spoof(rng, ln, spec.sample_rate))
        x = _wild_channel(rng, x, spec.sample_rate)
        write_wav(os.path.join(audio_dir, utt + ".wav"), x, spec.sample_rate)
        attack = "-" if bona else "A97"               # attack id unseen in ATTACKS
        label = "bonafide" if bona else "spoof"
        lines.append(f"LA_{i:04d} {utt} - {attack} {label}")
        utts.append(utt)
    proto_path = os.path.join(proto_dir, "ASVspoof2019.LA.cm.eval.trl.txt")
    with open(proto_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"eval": {"protocol": proto_path, "audio_dir": audio_dir,
                     "utt_ids": utts}}


def generate_fixture(root: str, spec: SyntheticSpec = SyntheticSpec()) -> dict:
    rng = np.random.default_rng(spec.seed)
    proto_dir = os.path.join(root, "ASVspoof2019_LA_cm_protocols")
    os.makedirs(proto_dir, exist_ok=True)
    n = int(spec.duration * spec.sample_rate)
    info = {}
    splits = [
        ("train", "trn", spec.n_train),
        ("dev", "trl", spec.n_dev),
        ("eval", "trl", spec.n_eval),
    ]
    for split, tag, count in splits:
        audio_dir = os.path.join(root, f"ASVspoof2019_LA_{split}", "flac")
        os.makedirs(audio_dir, exist_ok=True)
        lines: List[str] = []
        utts = []
        for i in range(count):
            utt = f"LA_{split[0].upper()}_{i:07d}"
            bona = i % 2 == 0
            # vary length so pad paths are exercised
            ln = n + int(rng.integers(-n // 4, n // 4))
            if spec.class_sep < 1.0:
                x = _hard_pair(rng, ln, spec.sample_rate, bona, spec.class_sep)
            else:
                # default path: exact round-1 RNG stream and signals
                x = (_bonafide(rng, ln, spec.sample_rate) if bona
                     else _spoof(rng, ln, spec.sample_rate))
            write_wav(os.path.join(audio_dir, utt + ".wav"), x, spec.sample_rate)
            attack = "-" if bona else ATTACKS[i % len(ATTACKS)]
            label = "bonafide" if bona else "spoof"
            lines.append(f"LA_{i:04d} {utt} - {attack} {label}")
            utts.append(utt)
        proto_path = os.path.join(proto_dir, f"ASVspoof2019.LA.cm.{split}.{tag}.txt")
        with open(proto_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        info[split] = {"protocol": proto_path, "audio_dir": audio_dir, "utt_ids": utts}
    return info
