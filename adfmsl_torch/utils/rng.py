"""Host-side seeding (the part of ``adfmsl/utils/rng.py`` the port uses).

``set_global_seed`` seeds numpy's and Python's global generators, as adfmsl's
does (the reference seeds them too, maze2.py:308-317). adfmsl also returns
the run's root JAX key, and ``key_for_step`` folds it per (purpose, step);
the port has no twin of either: its train steps draw from explicit
``torch.Generator`` streams seeded by (seed, epoch, step, shard)
(``train/state.py:TrainState.generators``). The ``torch.Generator`` returned
here seeds nothing of a step.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seed(seed: int) -> torch.Generator:
    """Seed numpy's and ``random``'s global generators; returns a CPU
    ``torch.Generator`` seeded with ``seed``."""
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)
