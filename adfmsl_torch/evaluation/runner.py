"""Batched evaluation runner: protocol -> score file (+ metrics).

Port of ``adfmsl/evaluation/runner.py`` (``produce_scores`` :37,
``evaluate_to_file`` :161). Kept as there: fixed-shape batches whose padding
rows are dropped by the loader's mask, scores in protocol order, non-finite
scores replaced by -1e9 and counted (the reference's NaN guard,
Maze6_Eval.py:474-493), and on one device the OOM half-batch retry (:90-115,
Maze6_Eval.py:509-535): a batch that runs out of device memory is scored in
two halves, a batch of one re-raises, and more than 100 such errors trip the
circuit breaker.

With a ``mesh`` (:77-89) each rank scores its row block of every batch,
padded to the data axis; the scores meet in one ``all_reduce`` of a
zero-filled global buffer after the loop, and rank 0 writes the score file,
equal to the one-process file (ids in protocol order, padding rows dropped).

``collect_features=True`` (:37-139) also keeps the model's pooled
``features`` from the same forward as the scores: they stay on the device
with the scores until the loop ends, split and meet again with them in the
OOM retry, are gathered with them under a mesh, and leave the device as
float32 (N, D) in protocol order. ``produce_embeddings`` (:143-160) returns
them with the ids and scores (``cli.evaluate --dump_embeddings``).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adfmsl_torch.data.pipeline import DataLoader
from adfmsl_torch.evaluation.metrics import compute_all_metrics
from adfmsl_torch.evaluation.scores import write_score_file

log = logging.getLogger(__name__)

MAX_OOM_ERRORS = 100        # the circuit breaker (Maze6_Eval.py:451)


@dataclass
class EvalResult:
    utt_ids: List[str]
    scores: np.ndarray
    n_nonfinite: int
    metrics: Optional[Dict[str, float]] = None
    features: Optional[np.ndarray] = None   # (N, D) when collect_features


def _score_with_retry(model: torch.nn.Module, audio: torch.Tensor, errors: List[int],
                      collect_features: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``model(audio)``'s scores (and features with ``collect_features``); on
    ``torch.OutOfMemoryError`` the batch is scored in two halves (each of
    which may split again), whose rows meet again in order."""
    try:
        out = model(audio)
        return out["scores"], (out["features"] if collect_features else None)
    except torch.OutOfMemoryError:
        if len(audio) < 2:
            raise
        errors[0] += 1
        if errors[0] > MAX_OOM_ERRORS:
            raise
        log.warning("eval batch of %d out of device memory; retrying in halves",
                    len(audio))
        h = len(audio) // 2
        (s1, f1), (s2, f2) = (_score_with_retry(model, audio[:h], errors, collect_features),
                              _score_with_retry(model, audio[h:], errors, collect_features))
        return torch.cat([s1, s2]), (torch.cat([f1, f2]) if collect_features else None)


def gather_rows(mesh, blocks: List[torch.Tensor], global_sizes: List[int]) -> np.ndarray:
    """Every rank's row blocks of each global batch, in batch order, through
    one ``all_reduce`` of a zero-filled buffer: (sum of global sizes, ...)."""
    first = blocks[0]
    buf = torch.zeros((sum(global_sizes), *first.shape[1:]), dtype=torch.float32,
                      device=first.device)
    off = 0
    for blk, n in zip(blocks, global_sizes):
        b = len(blk)
        start = off + mesh.data_rank * b
        buf[start:start + b] = blk.float()
        off += n
    dist.all_reduce(buf, group=mesh.data_group)
    return buf.cpu().numpy()


def _host_rows(mesh, pending, slot: int) -> List[np.ndarray]:
    """Each batch's ``pending[i][slot]`` on the host as float32: gathered from
    every rank under ``mesh``."""
    if mesh is None:
        return [p[slot].float().cpu().numpy() for p in pending]
    gathered = gather_rows(mesh, [p[slot] for p in pending], [len(p[2]) for p in pending])
    host, off = [], 0
    for p in pending:
        host.append(gathered[off:off + len(p[2])])
        off += len(p[2])
    return host


def produce_scores(model: torch.nn.Module, loader: DataLoader, mesh=None,
                   collect_features: bool = False) -> EvalResult:
    """Run batched inference on the model's device; returns per-utterance
    scores in protocol order (masked padding rows dropped). Scores stay on
    the device until the loop ends, so the host never waits on a batch.
    Under ``mesh`` the loader yields this rank's row blocks
    (``parallel/mesh.py:check_loader``) and every rank returns the whole
    result. ``collect_features=True`` also returns the pooled embeddings of
    the same forward (``EvalResult.features``)."""
    if mesh is not None:
        from adfmsl_torch.parallel.mesh import check_loader

        check_loader(mesh, loader)
    dev = next(model.parameters()).device
    pending = []
    errors = [0]
    with torch.inference_mode():
        for batch in loader:
            if mesh is not None:
                ids, mask = batch.global_ids, [u != "" for u in batch.global_ids]
            else:
                ids, mask = batch.utt_ids, batch.mask
            audio = torch.from_numpy(batch.audio).to(dev, non_blocking=True)
            if mesh is not None:
                out = model(audio)
                scores = out["scores"]
                feats = out["features"] if collect_features else None
            else:
                scores, feats = _score_with_retry(model, audio, errors, collect_features)
            pending.append((scores, feats, ids, mask))
    host = _host_rows(mesh, pending, 0) if pending else []
    host_feats = (_host_rows(mesh, pending, 1) if pending and collect_features
                  else [None] * len(pending))

    ids_out: List[str] = []
    all_scores: List[float] = []
    feats_out: List[np.ndarray] = []
    n_bad = 0
    for s, f, (_, _, utt_ids, mask) in zip(host, host_feats, pending):
        bad = ~np.isfinite(s)
        if bad.any():
            n_bad += int(bad.sum())
            s = np.where(bad, -1e9, s)
        keep = [i for i, (_, m) in enumerate(zip(utt_ids, mask)) if m and i < len(s)]
        ids_out.extend(utt_ids[i] for i in keep)
        all_scores.extend(s[keep])
        if f is not None:
            feats_out.append(f[keep])
    if n_bad:
        log.warning("replaced %d non-finite scores", n_bad)
    features = None
    if collect_features:
        features = (np.concatenate(feats_out).astype(np.float32, copy=False) if feats_out
                    else np.zeros((0,), np.float32))
    return EvalResult(ids_out, np.asarray(all_scores, dtype=np.float64), n_bad,
                      features=features)


@dataclass
class EmbeddingResult:
    utt_ids: List[str]
    features: np.ndarray            # (N, D) pooled embeddings
    scores: np.ndarray              # (N,)


def produce_embeddings(model: torch.nn.Module, loader: DataLoader,
                       mesh=None) -> EmbeddingResult:
    """Per-utterance pooled embeddings (the models' 'features' output) and
    scores, from one pass over the protocol (``produce_scores`` with
    ``collect_features``): the real-data input of the embedding-geometry
    figure (``analysis/figures.py:plot_embedding_geometry``)."""
    res = produce_scores(model, loader, mesh=mesh, collect_features=True)
    return EmbeddingResult(res.utt_ids, res.features, res.scores)


def evaluate_to_file(model: torch.nn.Module, loader: DataLoader, score_path: str,
                     labels: Optional[Dict[str, int]] = None,
                     asv_scores: Optional[str] = None, mesh=None,
                     collect_features: bool = False) -> EvalResult:
    """Score ``loader`` into ``score_path`` (under ``mesh``: written by rank 0
    only, the other ranks waiting for it) and compute the metrics."""
    res = produce_scores(model, loader, mesh=mesh, collect_features=collect_features)
    if mesh is None or mesh.rank == 0:
        n = write_score_file(score_path, res.utt_ids, res.scores)
        log.info("wrote %d scores to %s", n, score_path)
    if mesh is not None:
        dist.barrier()
    if labels:
        y = np.asarray([labels[u] for u in res.utt_ids if u in labels])
        s = np.asarray([sc for u, sc in zip(res.utt_ids, res.scores) if u in labels])
        costs = None
        if asv_scores:
            # official t-DCF: ASV operating point measured from the organizers'
            # ASV score file rather than the fixed typical-LA approximation
            from adfmsl_torch.evaluation.metrics import costs_from_asv_scores
            costs = costs_from_asv_scores(asv_scores)
        res.metrics = compute_all_metrics(s, y, tdcf_costs=costs)
    return res
