"""The explicit-collective data-parallel train step with shard-local BN (port
of ``adfmsl/parallel/shard_map_step.py``).

adfmsl's alternative to its GSPMD step, as torch-DDP trains: BatchNorm draws
its batch statistics from the rank's own rows, and the running statistics
are averaged over the data group after the step (``pmean``); a model-internal
loss (the FMSL head) and its gradients are averaged over the ranks; an
external loss keeps the global numerator over the global denominator
(``psum`` of each), so shards with different label mixes still give the
one-process loss. Each rank draws its own dropout / SpecAugment / LSA streams
(``TrainState.generators(..., shard=data_rank)``, adfmsl's ``fold_in`` of the
shard index). The guard, the clip and the update follow on the reduced
gradients, as in ``train/steps.py``, which holds the shared code.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.parallel.mesh import Mesh
from adfmsl_torch.train.steps import make_train_step


def make_shard_map_train_step(exp: ExperimentConfig, mesh: Mesh
                              ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, audio, labels, mask, rngs) -> metrics`` on this rank's
    rows, with shard-local BatchNorm."""
    return make_train_step(exp, mesh=mesh, local_bn=True)
