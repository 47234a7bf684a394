"""Host-side input pipeline: path resolution, decode+pad, fixed-shape batching,
threaded prefetch (the port's copy of ``adfmsl/data/pipeline.py``).

Audio paths resolve through the reference's three fixed layouts, then, with
``AsvspoofDataset(fuzzy_discovery=True)``, through ``FuzzyAudioResolver``'s
recursive index of the tree (in ``load`` and in the batch path alike).

Two ways to split the data over ranks:
- ``shard_index`` / ``num_shards``: adfmsl's per-host split of the utterance
  list into equal shards (the tail beyond an even split is dropped);
- ``rank`` / ``world``: every rank walks the single-process batch order (the
  same seeded shuffle) and yields, of each global batch padded to a multiple
  of ``world`` with masked rows, its contiguous row block, decoding only
  those rows (``Batch.global_ids`` holds the padded global batch's ids). This
  is the feed that keeps a data-parallel Trainer equal to the one-process one.

Replaces the reference's per-model torch ``Dataset``/``DataLoader`` copies
(maze2.py:244-302 and 13 near-duplicates). Differences by design:
- fixed static batch shapes always (XLA contract); the final eval batch is padded and
  carries a validity mask so the 71,237-utterance protocol keeps exact count
  (SURVEY.md section 7 risk list);
- decode runs in a background prefetch thread, and with ``use_native_io`` in
  ``num_workers`` native C++ threads a batch (``io_native.batch_decode_pad``),
  so the device never waits on the host;
- missing files produce zero-filled samples with a warning, mirroring the reference's
  failure tolerance (maze2.py:272-273).
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from adfmsl_torch.data.audio import load_audio
from adfmsl_torch.data.pad import pad
from adfmsl_torch.data.protocol import Protocol
from adfmsl_torch.io_native import batch_decode_pad
from adfmsl_torch.utils.profiling import annotate, count

log = logging.getLogger(__name__)

_EXTS = (".flac", ".wav")


def resolve_audio_path(base_dir: str, utt_id: str) -> Optional[str]:
    """Probe the directory layouts the reference supports (maze2.py:254-265:
    <base>/LA/flac/, <base>/flac/, <base>/) for .flac or .wav."""
    for sub in (("LA", "flac"), ("flac",), ()):
        for ext in _EXTS:
            p = os.path.join(base_dir, *sub, utt_id + ext)
            if os.path.exists(p):
                return p
    return None


class FuzzyAudioResolver:
    """Recursive-glob discovery with utt-id pattern matching — the eval scripts'
    robust dataset fallback (Maze5_eval.py:128 ``_discover_audio_files``, :169
    ``_find_matching_file``). One os.walk indexes every audio file under the root;
    lookups match exact stem first, then any stem containing the utt_id."""

    def __init__(self, root: str):
        self.root = root
        self._exact: Dict[str, str] = {}
        self._stems: List[Tuple[str, str]] = []
        for dirpath, _, files in os.walk(root):
            for f in files:
                stem, ext = os.path.splitext(f)
                if ext.lower() in _EXTS:
                    p = os.path.join(dirpath, f)
                    self._exact.setdefault(stem, p)
                    self._stems.append((stem, p))

    def __len__(self) -> int:
        return len(self._stems)

    def resolve(self, utt_id: str) -> Optional[str]:
        p = self._exact.get(utt_id)
        if p:
            return p
        for stem, path in self._stems:
            if utt_id in stem:
                return path
        return None


@dataclass
class Batch:
    """One fixed-shape batch. ``mask`` marks real (non-padding) rows. A
    loader's batch is rank ``rank``'s block of a global batch and carries the
    global batch's ids (padded with '' to a multiple of ``world``; at a world
    of one, ``utt_ids``)."""

    audio: np.ndarray          # [B, cut] float32
    label: np.ndarray          # [B] int32 (zeros when unlabeled)
    mask: np.ndarray           # [B] bool
    utt_ids: List[str]
    global_ids: Optional[List[str]] = None


class AsvspoofDataset:
    """Maps utt_ids -> (decoded, padded waveform, label). ``labeled=False``
    gives every utterance label 0; ``fuzzy_discovery`` indexes the tree under
    ``base_dir`` once and tries it after the three fixed layouts."""

    def __init__(
        self,
        protocol: Protocol,
        base_dir: str,
        cut: int = 64600,
        pad_mode: str = "tile",
        sample_rate: int = 16000,
        labeled: bool = True,
        fuzzy_discovery: bool = False,
        use_native_io: bool = True,
        num_workers: int = 2,
    ):
        self.protocol = protocol
        self.base_dir = base_dir
        self.cut = cut
        self.pad_mode = pad_mode
        self.sample_rate = sample_rate
        self.labeled = labeled
        self.use_native_io = use_native_io
        self.num_workers = max(1, num_workers)
        self._labels = protocol.labels if labeled else {}
        self._warned = 0
        self._fuzzy = FuzzyAudioResolver(base_dir) if fuzzy_discovery else None

    def __len__(self) -> int:
        return len(self.protocol)

    def _resolve(self, utt_id: str) -> Optional[str]:
        path = resolve_audio_path(self.base_dir, utt_id)
        if path is None and self._fuzzy is not None:
            path = self._fuzzy.resolve(utt_id)
        if path is None and self._warned < 20:
            log.warning("missing audio for %s under %s; using zeros", utt_id,
                        self.base_dir)
            self._warned += 1
        return path

    def load(self, utt_id: str) -> Tuple[np.ndarray, int]:
        path = self._resolve(utt_id)
        if path is None:
            return np.zeros(self.cut, dtype=np.float32), self._labels.get(utt_id, 0)
        x, _ = load_audio(path, self.sample_rate, prefer_native=self.use_native_io)
        return pad(x, self.cut, self.pad_mode).astype(np.float32), self._labels.get(utt_id, 0)

    def load_batch(self, ids: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Decode+pad a whole batch. With ``use_native_io`` the C++ thread-pooled
        loader decodes all files in one call (``num_workers`` native threads,
        the reference's DataLoader(num_workers=...) analog, maze2.py:473);
        rows whose source rate differs from ``sample_rate`` are reloaded
        through the per-file resampling path."""
        labels = np.asarray([self._labels.get(u, 0) for u in ids], dtype=np.int32)
        if not (self.use_native_io and ids):
            audio = np.stack([self.load(u)[0] for u in ids]) if ids else (
                np.zeros((0, self.cut), dtype=np.float32))
            return audio, labels

        paths = [self._resolve(u) or "" for u in ids]
        audio, srs, lens = batch_decode_pad(paths, self.cut, self.pad_mode,
                                            n_threads=self.num_workers)
        for i, (p, sr, ln) in enumerate(zip(paths, srs, lens)):
            if p and ln > 0 and sr != self.sample_rate:
                audio[i], _ = self.load(ids[i])   # rare: resample path
        return audio, labels


def _make_batch(ds: AsvspoofDataset, ids: Sequence[str], batch_size: int) -> Batch:
    audio = np.zeros((batch_size, ds.cut), dtype=np.float32)
    label = np.zeros(batch_size, dtype=np.int32)
    mask = np.zeros(batch_size, dtype=bool)
    if ids:
        a, y = ds.load_batch(ids)
        audio[: len(ids)], label[: len(ids)], mask[: len(ids)] = a, y, True
    return Batch(audio, label, mask, list(ids) + [""] * (batch_size - len(ids)))


def _make_block(ds: AsvspoofDataset, ids: Sequence[str], batch_size: int, rank: int,
                world: int) -> Batch:
    """Rank ``rank``'s row block of the global batch ``ids`` padded to
    ``batch_size`` and then to a multiple of ``world``; only its rows decode."""
    n = -(-batch_size // world) * world
    global_ids = list(ids) + [""] * (n - len(ids))
    b = n // world
    out = _make_batch(ds, [u for u in global_ids[rank * b:(rank + 1) * b] if u], b)
    out.global_ids = global_ids
    return out


class DataLoader:
    """Seeded-shuffle, fixed-shape, prefetching batch iterator.

    ``shard_index`` / ``num_shards`` split the utterance list across hosts
    (adfmsl :180-206); ``rank`` / ``world`` yield this rank's row block of
    each global batch (``batch_size`` stays the global batch)."""

    def __init__(
        self,
        dataset: AsvspoofDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 1234,
        prefetch: int = 4,
        shard_index: int = 0,
        num_shards: int = 1,
        rank: int = 0,
        world: int = 1,
    ):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.rank, self.world = rank, world
        self.epoch = 0
        ids = dataset.protocol.utt_ids
        if num_shards > 1:
            # equal shards: a host with one more utterance would run one more
            # (or fewer) batch than its peers and hang them in a collective
            n_even = (len(ids) // num_shards) * num_shards
            if n_even < len(ids):
                log.info("host sharding drops %d tail utterances for equal shards",
                         len(ids) - n_even)
            ids = ids[:n_even]
        self.ids = ids[shard_index::num_shards]

    def _epoch_ids(self) -> List[str]:
        ids = list(self.ids)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(ids)
        return ids

    def __len__(self) -> int:
        n = len(self.ids)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        ids = self._epoch_ids()
        self.epoch += 1
        chunks = []
        for i in range(0, len(ids), self.batch_size):
            chunk = ids[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            chunks.append(chunk)
        def make(c: Sequence[str]) -> Batch:
            return _make_block(self.ds, c, self.batch_size, self.rank, self.world)

        if self.prefetch <= 0:
            for i, c in enumerate(chunks):
                _counted_get(0)
                with annotate("stage.loader.get", i):
                    batch = make(c)
                yield batch
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that keeps checking stop — a worker blocked forever
            in q.put() would never see an early-abandoning consumer (e.g.
            next(iter(loader))) and leak the thread + prefetched batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for c in chunks:
                    if stop.is_set():
                        return
                    if not put(make(c)):
                        return
            except Exception as e:  # surface decoder errors on the consumer side
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            # one get a chunk: the worker's closing None is never waited for
            for i in range(len(chunks)):
                _counted_get(q.qsize())
                with annotate("stage.loader.get", i):
                    item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _counted_get(ready: int) -> None:
    """The loader's counters at a get that found ``ready`` batches queued."""
    count("loader.gets")
    count("loader.ready", ready)
    if not ready:
        count("loader.empty_gets")
