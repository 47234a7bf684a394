"""Offline preprocessing utilities (the port's copy of ``adfmsl/data/preprocess.py``;
numpy, on the host).

Rebuild of ``Thesis/06_Utilities/data_preprocessor.py:15-148``: silence trim +
pad/crop (preprocess_audio), dataset manifest CSV (create_dataset_manifest), and
protocol-vs-filesystem integrity validation (validate_dataset) — without librosa/
pandas dependencies on the hot path.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from adfmsl_torch.data.audio import load_audio
from adfmsl_torch.data.pad import pad
from adfmsl_torch.data.pipeline import resolve_audio_path
from adfmsl_torch.data.protocol import Protocol


def trim_silence(x: np.ndarray, top_db: float = 30.0, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """librosa.effects.trim semantics: drop leading/trailing frames more than
    ``top_db`` below the clip's peak RMS."""
    if len(x) < frame_length:
        return x
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(x[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return x
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return x
    start = keep[0] * hop_length
    end = min(keep[-1] * hop_length + frame_length, len(x))
    return x[start:end]


def preprocess_audio(path: str, target_sr: int = 16000, max_len: int = 64600,
                     pad_mode: str = "tile", trim: bool = True,
                     top_db: float = 30.0) -> np.ndarray:
    """Load -> (trim) -> pad/crop (data_preprocessor.py:15-45 analog)."""
    x, _ = load_audio(path, target_sr)
    if trim:
        x = trim_silence(x, top_db)
    return pad(x, max_len, pad_mode)


@dataclass
class ManifestEntry:
    utt_id: str
    path: str
    n_samples: int
    duration_s: float
    label: Optional[int]
    attack_type: str


def create_dataset_manifest(protocol: Protocol, base_dir: str, out_csv: str,
                            sample_rate: int = 16000) -> List[ManifestEntry]:
    """CSV manifest of every protocol utterance (data_preprocessor.py:47-99 analog)."""
    labels = protocol.labels
    attacks = protocol.attack_types
    entries: List[ManifestEntry] = []
    for utt in protocol.utt_ids:
        p = resolve_audio_path(base_dir, utt)
        if p is None:
            entries.append(ManifestEntry(utt, "", 0, 0.0, labels.get(utt),
                                         attacks.get(utt, "-")))
            continue
        x, sr = load_audio(p, sample_rate)
        entries.append(ManifestEntry(utt, p, len(x), len(x) / sr,
                                     labels.get(utt), attacks.get(utt, "-")))
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["utt_id", "path", "n_samples", "duration_s", "label",
                    "attack_type"])
        for e in entries:
            w.writerow([e.utt_id, e.path, e.n_samples, f"{e.duration_s:.3f}",
                        "" if e.label is None else e.label, e.attack_type])
    return entries


@dataclass
class ValidationReport:
    total: int
    found: int
    missing: List[str]
    empty: List[str]

    @property
    def ok(self) -> bool:
        return not self.missing and not self.empty


def validate_dataset(protocol: Protocol, base_dir: str,
                     check_decode: bool = False) -> ValidationReport:
    """Check every protocol entry has a decodable audio file
    (data_preprocessor.py:100-148 + validate_database_paths maze6.py:284-369)."""
    missing, empty = [], []
    for utt in protocol.utt_ids:
        p = resolve_audio_path(base_dir, utt)
        if p is None:
            missing.append(utt)
            continue
        if os.path.getsize(p) == 0:
            empty.append(utt)
        elif check_decode:
            try:
                x, _ = load_audio(p)
                if len(x) == 0:
                    empty.append(utt)
            except Exception:
                empty.append(utt)
    n = len(protocol)
    return ValidationReport(n, n - len(missing), missing, empty)


def explore_data_structure(root: str, max_depth: int = 3,
                           max_entries: int = 8) -> str:
    """Directory-layout report (maze4_fmsl_standardized.py:353-511
    ``explore_data_structure`` analog): tree of subdirs with audio-file counts,
    used to debug dataset path problems."""
    lines: List[str] = [root]

    def walk(d: str, depth: int, prefix: str):
        if depth > max_depth:
            return
        try:
            entries = sorted(os.listdir(d))
        except OSError as e:
            lines.append(f"{prefix}<unreadable: {e}>")
            return
        dirs = [e for e in entries if os.path.isdir(os.path.join(d, e))]
        audio = [e for e in entries if e.lower().endswith((".flac", ".wav"))]
        other = len(entries) - len(dirs) - len(audio)
        if audio or other:
            lines.append(f"{prefix}[{len(audio)} audio files, {other} other]")
        for sub in dirs[:max_entries]:
            lines.append(f"{prefix}{sub}/")
            walk(os.path.join(d, sub), depth + 1, prefix + "  ")
        if len(dirs) > max_entries:
            lines.append(f"{prefix}... +{len(dirs) - max_entries} more dirs")

    walk(root, 1, "  ")
    return "\n".join(lines)
