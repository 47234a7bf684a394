"""Early stopping (the port's copy of ``adfmsl/train/early_stop.py``;
maze3.py:391-425 EarlyStopper, maze6.py:737-752 patience loop)."""
from __future__ import annotations

from typing import Optional


class EarlyStopper:
    def __init__(self, patience: int = 3, min_delta: float = 0.0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0

    def improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def step(self, value: float) -> bool:
        """Record a metric; returns True when training should stop."""
        if self.improved(value):
            self.best = value
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience
