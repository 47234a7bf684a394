"""Train state (port of ``adfmsl/train/state.py``): the model (parameters and
BN running statistics), the optimizer (its moments, update count and plateau
scale), the step counter and the seed of the per-step random streams.

adfmsl draws three streams per step, 'dropout', 'specaugment' and 'lsa'
(``train/steps.py:57-64``), and a fourth, ``fold_in(rng, 3)``, for waveform
augmentation (:69), from ``key_for_step(root, 'dropout', epoch * 100000 +
i)`` (``train/loop.py:146-147``). The port gives each stream its own
``torch.Generator`` on the model's device, seeded from (seed, epoch, step,
stream) through numpy's ``SeedSequence``: reproducible, independent of what
ran before, and never equal to JAX's bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from adfmsl_torch.train.optim import Optimizer

# adfmsl utils/rng.py:_PURPOSES tags; 'augment' feeds data/augment.py
STREAMS = {"dropout": 1, "specaugment": 2, "lsa": 3, "augment": 6}


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    seed: int
    step: int = 0

    def generators(self, epoch: int, index: int, shard: int = 0
                   ) -> Dict[str, torch.Generator]:
        """The per-stream generators of step ``index`` of ``epoch``; data rank
        ``shard`` > 0 draws its own streams (adfmsl folds the shard index into
        each key, ``parallel/shard_map_step.py:52-56``), shard 0 those of one
        process."""
        dev = next(self.model.parameters()).device
        out = {}
        for name, tag in STREAMS.items():
            entropy = [self.seed, epoch, index, tag] + ([shard] if shard else [])
            words = np.random.SeedSequence(entropy).generate_state(2)
            g = torch.Generator(device=dev)
            g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
            out[name] = g
        return out
