"""Packed-array dataset: decode + pad the corpus ONCE, then stream from mmap
(the port's copy of ``adfmsl/data/pack.py``).

Decoding FLAC sets the pace of a protocol run at a few native threads
(PERF.md §5). A pack preprocesses the protocol once into a single contiguous
float32 array of fixed-shape clips (the static-shape contract the pipeline
already enforces), and every later epoch reads rows with no decode work. This
is the production analog of the reference's offline preprocessing utilities
(data_preprocessor.py:15-148), which re-decode per epoch instead.

Layout, adfmsl's key for key, so a pack written by either package loads in the
other: ``{prefix}.npy`` — (N, cut) float32, row i = tile/zero-padded clip of
utt_ids[i]; ``{prefix}.json`` — {utt_ids, cut, pad_mode, sample_rate, labels}.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from adfmsl_torch.data.pipeline import AsvspoofDataset
from adfmsl_torch.data.protocol import Protocol, ProtocolEntry


def create_pack(protocol: Protocol, audio_dir: str, out_prefix: str,
                cut: int = 64600, pad_mode: str = "tile",
                sample_rate: int = 16000, num_workers: int = 4,
                use_native_io: bool = True, batch: int = 256) -> Tuple[str, str]:
    """Decode every protocol utterance into ``{prefix}.npy`` (+ ``.json`` meta).

    Returns (npy_path, json_path). Decode runs through AsvspoofDataset's batch
    path (the native decoder's thread pool), ``batch`` utterances at a time."""
    ds = AsvspoofDataset(protocol, audio_dir, cut=cut, pad_mode=pad_mode,
                         sample_rate=sample_rate, use_native_io=use_native_io,
                         num_workers=num_workers)
    ids = protocol.utt_ids
    npy_path = out_prefix + ".npy"
    json_path = out_prefix + ".json"
    os.makedirs(os.path.dirname(os.path.abspath(npy_path)), exist_ok=True)
    out = np.lib.format.open_memmap(npy_path, mode="w+",
                                    dtype=np.float32, shape=(len(ids), cut))
    for i in range(0, len(ids), batch):
        chunk = ids[i: i + batch]
        audio, _ = ds.load_batch(chunk)
        out[i: i + len(chunk)] = audio
    out.flush()
    del out
    with open(json_path, "w") as fh:
        json.dump({"utt_ids": ids, "cut": cut, "pad_mode": pad_mode,
                   "sample_rate": sample_rate,
                   "labels": protocol.labels}, fh)
    return npy_path, json_path


class PackedDataset:
    """AsvspoofDataset-compatible reader over a pack (mmap'd, zero decode).

    Drop-in for DataLoader: exposes ``protocol``, ``cut`` and ``load_batch``.
    ``protocol`` defaults to one rebuilt from the pack metadata (ids + labels);
    pass the real Protocol to keep attack-type metadata.
    """

    def __init__(self, prefix: str, protocol: Optional[Protocol] = None):
        with open(prefix + ".json") as fh:
            meta = json.load(fh)
        self._audio = np.load(prefix + ".npy", mmap_mode="r")
        self.cut = int(meta["cut"])
        self.pad_mode = meta["pad_mode"]
        self.sample_rate = int(meta["sample_rate"])
        pack_labels = {k: int(v) for k, v in (meta.get("labels") or {}).items()}
        self._ids = list(meta["utt_ids"])
        self._index = {u: i for i, u in enumerate(self._ids)}
        if protocol is None:
            protocol = Protocol([
                ProtocolEntry("-", u, "-", pack_labels.get(u)) for u in self._ids])
            self._labels = pack_labels
        else:
            # The caller's protocol is authoritative for labels: it carries the
            # experiment's label polarity ('spoof1' compat flag etc.), while the
            # pack metadata froze whatever polarity the pack was written with.
            # Audio rows are polarity-independent, so only ids must match.
            missing = [u for u in protocol.utt_ids if u not in self._index]
            if missing:
                raise KeyError(
                    f"{len(missing)} protocol utterances missing from pack "
                    f"(first: {missing[:3]}) — re-run python -m adfmsl_torch.cli.pack "
                    f"on this protocol")
            self._labels = protocol.labels or pack_labels
        self.protocol = protocol

    def __len__(self) -> int:
        return len(self.protocol)

    def load(self, utt_id: str):
        i = self._index[utt_id]
        return np.asarray(self._audio[i], dtype=np.float32), \
            self._labels.get(utt_id, 0)

    def load_batch(self, ids: Sequence[str]):
        idx = np.asarray([self._index[u] for u in ids], dtype=np.int64)
        labels = np.asarray([self._labels.get(u, 0) for u in ids], dtype=np.int32)
        audio = np.empty((len(ids), self.cut), dtype=np.float32)
        # one copy a row, straight into its place, in file order (sorted reads
        # are sequential on disk)
        for j in np.argsort(idx):
            audio[j] = self._audio[idx[j]]
        return audio, labels
