"""Checkpoints of the full train state with best-metric retention (port of
``adfmsl/train/checkpoint.py``).

adfmsl keeps an Orbax ``CheckpointManager`` over the whole TrainState plus a
metrics dict per epoch, retaining the best ``max(keep_best_k, keep_last)``
epochs by ``best_fn`` (:28-40; no caller sets ``keep_last``, so the port
keeps ``max(keep_best_k, 1)``): a NaN or missing metric ranks worst, and
among those the newest epoch wins; ties keep the newest. Restore takes the latest
retained epoch; ``restore_params`` takes the model alone from the best. The port writes one directory per epoch under ``directory``:

    epoch_<e>/model.pt        the experiment config and the model's state dict
                              (``models/port.py:save_checkpoint``), which
                              ``cli.evaluate --model_path`` reads
    epoch_<e>/train_state.pt  the optimizer state, update count, plateau
                              scale and step counter
    epoch_<e>/metrics.json    the epoch's metrics

``models/port.py:load_checkpoint`` on ``directory`` reads the latest epoch's
``model.pt``, as adfmsl's evaluate restores the latest epoch.
"""
from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.models.port import (CHECKPOINT_FILE, epoch_dir, epoch_dirs,
                                      load_checkpoint, save_checkpoint)
from adfmsl_torch.train.state import TrainState

TRAIN_STATE_FILE = "train_state.pt"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str, keep_best_k: int = 1,
                 metric: str = "dev_acc", mode: str = "max"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(keep_best_k, 1)
        self.metric = metric
        self.mode = mode

    def _rank(self, epoch: int, metrics: Dict[str, float]) -> float:
        """adfmsl's ``best_fn``: larger is better for 'max', smaller for 'min'."""
        v = metrics.get(self.metric)
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return (-1e30 + epoch) if self.mode == "max" else (1e30 - epoch)
        return v

    def _ranked(self) -> List[int]:
        """Retained epochs from worst to best; among equals the newest is last
        (a stable sort of the epochs in order, reversed for 'min')."""
        epochs = self.all_epochs()
        metrics = {e: self.metrics(e) for e in epochs}
        return sorted(epochs, key=lambda e: self._rank(e, metrics[e]),
                      reverse=self.mode == "min")

    def _path(self, epoch: int) -> str:
        return epoch_dir(self.directory, epoch)

    def save(self, epoch: int, exp: ExperimentConfig, state: TrainState,
             metrics: Dict[str, float]) -> None:
        path = self._path(epoch)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        save_checkpoint(tmp, exp, state.model)
        torch.save({"optimizer": state.optimizer.state_dict(), "step": state.step},
                   os.path.join(tmp, TRAIN_STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as fh:
            json.dump({k: float(v) for k, v in metrics.items()}, fh)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        ranked = self._ranked()
        for e in ranked[:-self.keep]:
            shutil.rmtree(self._path(e))

    def metrics(self, epoch: int) -> Dict[str, float]:
        with open(os.path.join(self._path(epoch), METRICS_FILE)) as fh:
            return json.load(fh)

    def restore(self, state: TrainState, epoch: Optional[int] = None
                ) -> Tuple[TrainState, int]:
        """Load the latest retained epoch (or ``epoch``) into ``state``;
        returns (state, epoch)."""
        epochs = self.all_epochs()
        if epoch is None:
            if not epochs:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            epoch = epochs[-1]
        path = self._path(epoch)
        dev = next(state.model.parameters()).device
        _, sd = load_checkpoint(path, map_location=dev)
        state.model.load_state_dict(sd, strict=True)
        ts = torch.load(os.path.join(path, TRAIN_STATE_FILE), map_location=dev,
                        weights_only=True)
        state.optimizer.load_state_dict(ts["optimizer"])
        state.step = int(ts["step"])
        return state, epoch

    def restore_params(self, model: torch.nn.Module, epoch: Optional[int] = None
                       ) -> int:
        """Load only the model's parameters and BN buffers (``model.pt``) of
        ``epoch``, or of the best retained epoch (``best_epoch``: the newest
        among equals), into ``model``; the optimizer state is left out
        (adfmsl :72-92: a trained trunk carried into another training setup,
        e.g. few-shot meta-training). Returns the epoch."""
        if epoch is None:
            epoch = self.best_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        dev = next(model.parameters()).device
        _, sd = load_checkpoint(self._path(epoch), map_location=dev)
        model.load_state_dict(sd, strict=True)
        return epoch

    def best_epoch(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def all_epochs(self) -> List[int]:
        return [e for e, _ in epoch_dirs(self.directory)]


__all__ = ["CHECKPOINT_FILE", "CheckpointManager", "METRICS_FILE", "TRAIN_STATE_FILE"]
