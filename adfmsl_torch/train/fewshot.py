"""Episodic few-shot training driver (port of ``adfmsl/train/fewshot.py``).

A registry trunk is the embedder (its 'features' output). ``fit`` meta-trains
it on prototypical episodes over per-attack-type classes
(``heads/episodic.py``), with Adam at ``FewshotConfig.lr`` after a global-norm
clip at 1.0 (adfmsl's ``optax.chain(clip_by_global_norm(1.0), adam(lr))``);
``adapt`` builds class prototypes from K labelled utterances of a new domain,
and ``score`` / ``score_protocol`` give CM scores against them.

The meta step embeds in train mode: the BN running statistics move once a
step, and the 'dropout', 'specaugment' and 'lsa' streams come from
generators seeded like ``TrainState.generators`` (adfmsl's ``_step_rngs``,
:34). Adaptation and scoring embed in eval mode with the current statistics
(through the K1 kernel on the card when ``extra.fused_eval_trunk`` is set).

Under ``mesh`` (adfmsl :65-72, :115-145) rank 0's weights are broadcast and
the episode axis is sharded over the data group: every rank samples the
whole episode batch from the same seed and decodes its block of episodes;
BatchNorm is global and the loss is the global cross-episode mean
(``heads/episodic.py``). Adaptation and scoring run whole on every rank.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from adfmsl_torch.config.base import ExperimentConfig, OptimizerConfig
from adfmsl_torch.data.pipeline import AsvspoofDataset
from adfmsl_torch.data.protocol import Protocol
from adfmsl_torch.device import resolve_device
from adfmsl_torch.heads.episodic import (EpisodeSampler, kshot_adapt,
                                         make_episodic_train_step, prototype_scores)
from adfmsl_torch.models.mazes import build_model
from adfmsl_torch.train.checkpoint import CheckpointManager
from adfmsl_torch.train.optim import Optimizer
from adfmsl_torch.train.state import TrainState

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FewshotConfig:
    n_way: int = 2
    k_shot: int = 5
    q_queries: int = 5
    episodes_per_batch: int = 4
    n_steps: int = 100
    temperature: float = 10.0
    metric: str = "cosine"
    lr: float = 1e-3


class FewshotTrainer:
    """Meta-train a trunk with prototypical episodes on ``device`` (``None``
    means ``cuda``; a missing card raises).

    ``checkpoint_dir`` warm-starts the embedder's parameters and BN running
    statistics from a supervised (or earlier meta-training) checkpoint
    (``CheckpointManager.restore_params``)."""

    def __init__(self, exp: ExperimentConfig, fcfg: FewshotConfig,
                 protocol: Protocol, dataset: AsvspoofDataset,
                 checkpoint_dir: Optional[str] = None, mesh=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.exp, self.fcfg, self.mesh = exp, fcfg, mesh
        self.device = resolve_device(device)
        self.model = build_model(exp.model, device=self.device, seed=exp.train.seed)
        self.start_epoch = None
        if checkpoint_dir:
            self.start_epoch = CheckpointManager(checkpoint_dir).restore_params(self.model)
            log.info("warm-started embedder from %s (epoch %s)",
                     checkpoint_dir, self.start_epoch)
        if mesh is not None:
            from adfmsl_torch.parallel.mesh import replicate

            replicate(mesh, self.model)
        ocfg = OptimizerConfig(name="adam", lr=fcfg.lr, weight_decay=0.0,
                               grad_clip_norm=1.0)
        self.optimizer = Optimizer(ocfg, self.model.parameters(), 1, 1)
        # the per-step generators: TrainState's recipe from seed + 1, the
        # seed of adfmsl's step key (:142)
        self.state = TrainState(self.model, self.optimizer, seed=exp.train.seed + 1)
        self.step_fn = make_episodic_train_step(self.embed_train, self.optimizer,
                                                fcfg.temperature, fcfg.metric, mesh)
        self.sampler = EpisodeSampler(
            protocol, lambda u: dataset.load(u)[0], fcfg.n_way, fcfg.k_shot,
            fcfg.q_queries, fcfg.episodes_per_batch, exp.train.seed,
            load_batch_fn=lambda ids: dataset.load_batch(ids)[0],
            shard=(mesh.data_rank, mesh.dp) if mesh is not None else (0, 1))
        self.history: List[Dict[str, float]] = []

    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        """Eval-mode features with the current BN statistics, outside autograd."""
        self.model.eval()
        with torch.no_grad():
            return self.model(audio)["features"]

    def embed_train(self, audio: torch.Tensor,
                    rngs: Optional[Mapping[str, torch.Generator]] = None) -> torch.Tensor:
        """Train-mode features (the BN running statistics move)."""
        self.model.train()
        return self.model(audio, rngs=rngs)["features"]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(self.device)

    def fit(self, n_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = n_steps or self.fcfg.n_steps
        for i in range(n):
            t0 = time.time()
            b = self.sampler.next_batch()
            rngs = self.state.generators(
                0, self.state.step, self.mesh.data_rank if self.mesh is not None else 0)
            m = self.step_fn(self._tensor(b.support), self._tensor(b.query), rngs)
            self.state.step += 1
            rec = {"step": i, "loss": float(m["loss"]), "acc": float(m["acc"]),
                   "seconds": time.time() - t0}
            self.history.append(rec)
            if i % 10 == 0:
                log.info("episode step %d loss %.4f acc %.3f", i, rec["loss"],
                         rec["acc"])
        return self.history

    # ---- K-shot adaptation to an unseen domain ---------------------------------

    def adapt(self, support_audio: np.ndarray, support_labels: np.ndarray,
              n_classes: int = 2) -> torch.Tensor:
        labels = torch.as_tensor(np.asarray(support_labels)).to(self.device)
        return kshot_adapt(self.embed, self._tensor(support_audio), labels, n_classes)

    def score(self, audio: np.ndarray, prototypes: torch.Tensor) -> np.ndarray:
        s = prototype_scores(self.embed, self._tensor(audio), prototypes,
                             temperature=self.fcfg.temperature)
        return s.float().cpu().numpy()

    def score_protocol(self, dataset: AsvspoofDataset, prototypes: torch.Tensor,
                       batch_size: int = 32) -> Dict[str, float]:
        """CM scores for every utterance in the dataset's protocol; the last
        chunk is padded with silence to ``batch_size``, as adfmsl does."""
        utts = dataset.protocol.utt_ids
        out: Dict[str, float] = {}
        for i in range(0, len(utts), batch_size):
            chunk = utts[i: i + batch_size]
            audio, _ = dataset.load_batch(chunk)
            pad = batch_size - len(chunk)
            if pad:
                audio = np.pad(audio, [(0, pad), (0, 0)])
            for u, sc in zip(chunk, self.score(audio, prototypes)):
                out[u] = float(sc)
        return out
