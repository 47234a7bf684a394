"""Episodic N-way K-shot prototypical training and K-shot adaptation (port of
``adfmsl/heads/episodic.py``).

Episodes are sampled per attack type (ASVspoof A01..A19 and bonafide): each
holds N classes with K support and Q query utterances. The host side is a
copy of adfmsl's (the same numpy generator draws the same episodes); the math
runs on tensors, with adfmsl's ``vmap`` over episodes as batched operations on
the (E, N, K, D) layout:

- prototypes are the class means of the L2-normalised support embeddings,
  normalised again (on the hypersphere);
- logits are the scaled cosine to each prototype (or the negative scaled
  squared distance), and each episode's loss is the cross-entropy of its
  queries against their class index;
- K-shot adaptation to an unseen domain is the same prototype computation
  over a labelled support set, with no gradient step; its CM score is the
  log-softmax probability of the bonafide class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from adfmsl_torch.data.protocol import Protocol
from adfmsl_torch.heads.fmsl import l2_normalize

if TYPE_CHECKING:
    from adfmsl_torch.parallel.mesh import Mesh
    from adfmsl_torch.train.optim import Optimizer


# ------------------------------------------------------------------ sampling ----

@dataclass
class EpisodeBatch:
    """Fixed-shape episode batch.

    support: (E, N, K, ...) audio or features
    query:   (E, N, Q, ...)
    Labels are implicit: class index within the episode (query i of class c has
    label c)."""

    support: np.ndarray
    query: np.ndarray
    class_names: List[List[str]]      # per-episode sampled class names


def group_by_class(protocol: Protocol, bonafide_as_class: bool = True
                   ) -> Dict[str, List[str]]:
    """utt_ids grouped by attack type ('-' = bonafide)."""
    groups: Dict[str, List[str]] = {}
    for e in protocol.entries:
        name = "bonafide" if e.attack_type == "-" and bonafide_as_class else e.attack_type
        groups.setdefault(name, []).append(e.utt_id)
    return groups


def sample_episode_indices(rng: np.random.Generator, groups: Dict[str, List[str]],
                           n_way: int, k_shot: int, q_queries: int
                           ) -> Tuple[List[str], List[List[str]], List[List[str]]]:
    """Sample class names + per-class support/query utt_ids (without replacement
    within a class when possible)."""
    eligible = [c for c, utts in groups.items() if len(utts) >= k_shot + q_queries]
    if len(eligible) < n_way:
        raise ValueError(
            f"need {n_way} classes with >= {k_shot + q_queries} utterances; "
            f"have {len(eligible)}")
    classes = list(rng.choice(eligible, size=n_way, replace=False))
    support, query = [], []
    for c in classes:
        utts = rng.choice(groups[c], size=k_shot + q_queries, replace=False)
        support.append(list(utts[:k_shot]))
        query.append(list(utts[k_shot:]))
    return classes, support, query


class EpisodeSampler:
    """Draws fixed-shape EpisodeBatches of decoded audio from a protocol+dataset.

    ``load_batch_fn(ids) -> (len(ids), T) float32`` routes the whole episode
    batch through one decode call (``AsvspoofDataset.load_batch``, the native
    thread-pooled loader); ``load_fn`` is the one-utterance fallback.

    ``shard=(i, n)`` (a data-parallel rank ``i`` of ``n``) samples every
    episode, as one process does, and decodes and returns only the
    contiguous block of episodes [i·E/n, (i+1)·E/n)."""

    def __init__(self, protocol: Protocol,
                 load_fn: Optional[Callable[[str], np.ndarray]] = None,
                 n_way: int = 2, k_shot: int = 5, q_queries: int = 5,
                 episodes_per_batch: int = 4, seed: int = 1234,
                 load_batch_fn: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
                 shard: Tuple[int, int] = (0, 1)):
        if load_fn is None and load_batch_fn is None:
            raise ValueError("need load_fn or load_batch_fn")
        if episodes_per_batch % shard[1]:
            raise ValueError(f"{episodes_per_batch} episodes a batch do not tile "
                             f"{shard[1]} data ranks")
        self.shard = shard
        self.groups = group_by_class(protocol)
        self.load_fn = load_fn
        self.load_batch_fn = load_batch_fn
        self.n_way, self.k_shot, self.q = n_way, k_shot, q_queries
        self.e = episodes_per_batch
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> EpisodeBatch:
        sup_ids: List[List[List[str]]] = []
        qry_ids: List[List[List[str]]] = []
        names = []
        for _ in range(self.e):
            classes, sup, qry = sample_episode_indices(
                self.rng, self.groups, self.n_way, self.k_shot, self.q)
            sup_ids.append(sup)
            qry_ids.append(qry)
            names.append(classes)
        i, n = self.shard
        e = self.e // n
        sup_ids, qry_ids = sup_ids[i * e:(i + 1) * e], qry_ids[i * e:(i + 1) * e]
        names = names[i * e:(i + 1) * e]
        if self.load_batch_fn is not None:
            # one decode call for the whole batch (episode-major flat order)
            flat = [u for ep in sup_ids for cls in ep for u in cls] + \
                   [u for ep in qry_ids for cls in ep for u in cls]
            audio = np.asarray(self.load_batch_fn(flat), dtype=np.float32)
            ns = e * self.n_way * self.k_shot
            sup = audio[:ns].reshape(e, self.n_way, self.k_shot, -1)
            qry = audio[ns:].reshape(e, self.n_way, self.q, -1)
        else:
            sup = np.asarray([[[self.load_fn(u) for u in cls] for cls in ep]
                              for ep in sup_ids], dtype=np.float32)
            qry = np.asarray([[[self.load_fn(u) for u in cls] for cls in ep]
                              for ep in qry_ids], dtype=np.float32)
        return EpisodeBatch(sup, qry, names)


# ------------------------------------------------------------------ tensors ----

def prototypes_from_support(support_emb: torch.Tensor) -> torch.Tensor:
    """(..., N, K, D) L2-normalised embeddings -> (..., N, D) hypersphere
    prototypes (mean then re-normalise)."""
    return l2_normalize(support_emb.mean(dim=-2))


def prototypical_logits(query_emb: torch.Tensor, prototypes: torch.Tensor,
                        temperature: float = 10.0, metric: str = "cosine"
                        ) -> torch.Tensor:
    """(..., Q, D) x (..., N, D) -> (..., Q, N) logits."""
    if metric == "cosine":
        return temperature * (query_emb @ prototypes.transpose(-1, -2))
    if metric == "sqeuclidean":
        d = ((query_emb[..., :, None, :] - prototypes[..., None, :, :]) ** 2).sum(dim=-1)
        return -d * temperature
    raise ValueError(f"unknown metric {metric!r}")


def _episodes_loss(support_emb: torch.Tensor, query_emb: torch.Tensor,
                   temperature: float, metric: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Support (E, N, K, D), query (E, N, Q, D) -> per-episode (loss, acc), (E,)."""
    e, n_way, q, d = query_emb.shape
    protos = prototypes_from_support(support_emb)
    logits = prototypical_logits(query_emb.reshape(e, n_way * q, d), protos,
                                 temperature, metric)
    labels = torch.arange(n_way, device=logits.device).repeat_interleave(q)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels.expand(e, -1)[..., None])[..., 0].mean(dim=-1)
    acc = (logits.argmax(dim=-1) == labels).float().mean(dim=-1)
    return loss, acc


def episode_loss(support_emb: torch.Tensor, query_emb: torch.Tensor,
                 temperature: float = 10.0, metric: str = "cosine"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One episode: support (N, K, D), query (N, Q, D) -> (loss, acc)."""
    loss, acc = _episodes_loss(support_emb[None], query_emb[None], temperature, metric)
    return loss[0], acc[0]


def batched_episode_loss(support_emb: torch.Tensor, query_emb: torch.Tensor,
                         temperature: float = 10.0, metric: str = "cosine"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every episode at once: support (E, N, K, D), query (E, N, Q, D) -> the
    means over episodes of (loss, acc)."""
    loss, acc = _episodes_loss(support_emb, query_emb, temperature, metric)
    return loss.mean(), acc.mean()


EmbedTrainFn = Callable[[torch.Tensor, Optional[Mapping[str, torch.Generator]]],
                        torch.Tensor]


def make_episodic_train_step(embed_train_fn: EmbedTrainFn, optimizer: "Optimizer",
                             temperature: float = 10.0, metric: str = "cosine",
                             mesh: Optional["Mesh"] = None):
    """One episodic meta step, adfmsl's ``make_episodic_train_step`` (:165).

    ``embed_train_fn(audio_flat, rngs) -> (B, D)`` runs a trunk in train mode
    (its BN running statistics move once a step). Support and query are
    concatenated inside each episode and flattened with the episode axis
    outermost, E * N * (K + Q) rows, which decides the rows that share BN batch
    statistics, as in adfmsl. Then: L2 normalisation, the mean episode loss,
    backward, zero gradients for parameters the loss does not reach (as JAX
    gives them), the optimizer's global-norm clip and update.

    Under ``mesh`` the episode axis is sharded over the data group (each rank
    holds a contiguous block of episodes, so its flat rows are a row block of
    the global flat batch): BatchNorm is global (``data_parallel``), each
    rank's root is its episodes' loss sum over the global episode count, and
    the gradients are summed in one flat ``all_reduce``: adfmsl's
    cross-episode mean under GSPMD.

    step(support, query, rngs=None) -> {"loss", "acc"} (device scalars)
    """
    # imported here: adfmsl_torch.train imports this module (train/fewshot.py)
    import torch.distributed as dist

    from adfmsl_torch.parallel.collectives import all_reduce_flat, data_parallel
    from adfmsl_torch.train.optim import global_norm

    group = mesh.data_group if mesh is not None else None

    def step(support: torch.Tensor, query: torch.Tensor,
             rngs: Optional[Mapping[str, torch.Generator]] = None
             ) -> Dict[str, torch.Tensor]:
        e, n, k, t = support.shape
        q = query.shape[2]
        flat = torch.cat([support.reshape(e, n * k, t), query.reshape(e, n * q, t)],
                         dim=1).reshape(e * n * (k + q), t)
        with data_parallel(group):
            emb = l2_normalize(embed_train_fn(flat, rngs))
            d = emb.shape[-1]
            per_ep = emb.reshape(e, n * (k + q), d)
            sup = per_ep[:, : n * k].reshape(e, n, k, d)
            qry = per_ep[:, n * k:].reshape(e, n, q, d)
            if mesh is None:
                loss, acc = batched_episode_loss(sup, qry, temperature, metric)
                root = loss
            else:
                losses, accs = _episodes_loss(sup, qry, temperature, metric)
                sums = torch.stack([losses.detach().sum(), accs.sum()])
                dist.all_reduce(sums, group=group)
                e_global = e * mesh.dp
                loss, acc = sums[0] / e_global, sums[1] / e_global
                root = losses.sum() / e_global
            optimizer.zero_grad()
            root.backward()
        for p in optimizer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            all_reduce_flat([p.grad for p in optimizer.params], group)
        optimizer.clip_(global_norm(p.grad for p in optimizer.params))
        optimizer.step()
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step


def kshot_adapt(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                support_audio: torch.Tensor, support_labels: torch.Tensor,
                n_classes: int) -> torch.Tensor:
    """Class prototypes of an unseen domain from K labelled support examples:
    (n_classes, D)."""
    emb = l2_normalize(embed_fn(support_audio))
    protos = []
    for c in range(n_classes):
        m = (support_labels == c).to(emb.dtype)[:, None]
        protos.append((emb * m).sum(dim=0) / torch.clamp(m.sum(), min=1.0))
    return l2_normalize(torch.stack(protos))


def prototype_scores(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                     audio: torch.Tensor, prototypes: torch.Tensor,
                     bonafide_class: int = 1, temperature: float = 10.0) -> torch.Tensor:
    """CM scores from adapted prototypes: log-softmax prob of the bonafide class."""
    emb = l2_normalize(embed_fn(audio))
    logits = prototypical_logits(emb, prototypes, temperature)
    return torch.log_softmax(logits, dim=-1)[:, bonafide_class]
