"""The epoch loop (port of ``adfmsl/train/loop.py``: ``Trainer`` :42-295,
``make_dataset_and_loader`` :298).

As adfmsl: the model is built from ``exp.train.seed``; each step draws its
random streams from (seed, epoch, step); metrics accumulate on the device and
reach the host once an epoch; epochs continue across ``fit()`` calls and
after a restore (so streams, shuffles and checkpoint numbers never repeat);
a dev set gives accuracy and EER per epoch, which drive the checkpoint
retention, the plateau scale and early stopping; a Wav2Vec2 model gets its
pretrained encoder from ``wav2vec2.pretrained_path`` before the optimizer is
built, and the optimizer labels its parameters ('main', 'backbone', 'frozen'). ``mesh`` (data-parallel
training) comes with ROADMAP slice 8. adfmsl also writes ``experiment.yaml``
beside the checkpoints; here every epoch's ``model.pt`` carries the config.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.data.pipeline import AsvspoofDataset, Batch, DataLoader
from adfmsl_torch.data.protocol import Protocol
from adfmsl_torch.device import resolve_device
from adfmsl_torch.evaluation.metrics import compute_eer
from adfmsl_torch.models.mazes import build_model
from adfmsl_torch.models.pretrained import inject_pretrained_w2v2
from adfmsl_torch.train.checkpoint import CheckpointManager
from adfmsl_torch.train.early_stop import EarlyStopper
from adfmsl_torch.train.optim import Optimizer, PlateauTracker
from adfmsl_torch.train.state import TrainState
from adfmsl_torch.train.steps import make_eval_step, make_train_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EpochMetrics:
    epoch: int
    train_loss: float
    train_acc: float
    dev_acc: float
    seconds: float
    skipped_batches: int = 0
    dev_eer: float = float("nan")


class Trainer:
    """Drives train / dev epochs over host DataLoaders on ``device`` (``None``
    means ``cuda``; a missing card raises)."""

    def __init__(self, exp: ExperimentConfig, train_loader: DataLoader,
                 dev_loader: Optional[DataLoader] = None,
                 checkpoint_dir: Optional[str] = None,
                 mesh=None, device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise NotImplementedError("data-parallel training comes with ROADMAP slice 8")
        self.exp = exp
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        self.device = resolve_device(device)
        model = build_model(exp.model, device=self.device, seed=exp.train.seed)
        w2v2 = exp.model.wav2vec2
        if w2v2.pretrained_path or w2v2.require_pretrained:
            inject_pretrained_w2v2(model, w2v2)
        opt = Optimizer.for_model(exp, model, max(len(train_loader), 1))
        self.state = TrainState(model, opt, exp.train.seed)
        self.train_step = make_train_step(exp)
        self.eval_step = make_eval_step()
        self.ckpt = (CheckpointManager(checkpoint_dir, keep_best_k=exp.train.keep_best_k,
                                       metric=exp.train.early_stop_metric,
                                       mode=exp.train.early_stop_mode)
                     if checkpoint_dir else None)
        self.history: List[EpochMetrics] = []
        self.epochs_run = 0              # advanced by fit(); restore() sets it

    def restore(self) -> int:
        """Load the latest checkpoint; the next epoch continues after it."""
        self.state, epoch = self.ckpt.restore(self.state)
        self.epochs_run = epoch + 1
        return epoch

    def _place(self, batch: Batch):
        dev = self.device
        return (torch.from_numpy(batch.audio).to(dev, non_blocking=True),
                torch.from_numpy(batch.label).to(dev).long(),
                torch.from_numpy(batch.mask).to(dev))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        loss_sum = acc_sum = skip_sum = None
        i = 0
        for batch in self.train_loader:
            audio, label, mask = self._place(batch)
            m = self.train_step(self.state, audio, label, mask,
                                self.state.generators(epoch, i))
            if loss_sum is None:
                loss_sum, acc_sum, skip_sum = m["loss"], m["acc"], m["skipped"]
            else:
                loss_sum = loss_sum + m["loss"]
                acc_sum = acc_sum + m["acc"]
                skip_sum = skip_sum + m["skipped"]
            i += 1
            if self.exp.train.log_every_steps and i % self.exp.train.log_every_steps == 0:
                log.info("epoch %d step %d loss %.4f acc %.3f", epoch, i,
                         float(m["loss"]), float(m["acc"]))
        n = max(i, 1)
        return {"loss": float(loss_sum) / n if loss_sum is not None else 0.0,
                "acc": float(acc_sum) / n if acc_sum is not None else 0.0,
                "skipped": int(skip_sum) if skip_sum is not None else 0}

    def evaluate_metrics(self, loader: DataLoader):
        """(accuracy, eer) over a labelled loader; the device results reach
        the host once, after the loop."""
        pending = []
        for batch in loader:
            audio, label, mask = self._place(batch)
            out = self.eval_step(self.state, audio, label, mask)
            pending.append((out["correct"], out["count"], out["scores"], batch))
        correct = count = 0.0
        scores, labels = [], []
        for dc, dn, ds, batch in pending:
            correct += float(dc)
            count += float(dn)
            s = ds.float().cpu().numpy()
            scores += [float(v) for v, m in zip(s, batch.mask) if m]
            labels += [int(y) for y, m in zip(batch.label, batch.mask) if m]
        acc = correct / max(count, 1.0)
        eer = float("nan")
        if len(set(labels)) == 2:
            eer, _ = compute_eer(np.asarray(scores), np.asarray(labels))
        return acc, eer

    def fit(self, num_epochs: Optional[int] = None) -> List[EpochMetrics]:
        """``None`` trains up to ``exp.train.num_epochs`` in all (a resumed run
        trains the rest); an explicit count trains that many more."""
        n = (max(0, self.exp.train.num_epochs - self.epochs_run) if num_epochs is None
             else num_epochs)
        tc, ocfg = self.exp.train, self.exp.train.optimizer
        stopper = (EarlyStopper(tc.early_stop_patience, tc.early_stop_min_delta,
                                tc.early_stop_mode)
                   if tc.early_stop_patience > 0 else None)
        plateau = (PlateauTracker(ocfg.plateau_patience, ocfg.plateau_factor,
                                  mode=ocfg.plateau_mode)
                   if ocfg.scheduler == "plateau" else None)
        first = self.epochs_run
        for epoch in range(first, first + n):
            self.epochs_run = epoch + 1
            t0 = time.time()
            tm = self.train_epoch(epoch)
            dev_acc, dev_eer = (self.evaluate_metrics(self.dev_loader)
                                if self.dev_loader is not None
                                else (float("nan"), float("nan")))
            em = EpochMetrics(epoch, tm["loss"], tm["acc"], dev_acc,
                              time.time() - t0, tm["skipped"], dev_eer)
            self.history.append(em)
            log.info("epoch %d done: loss %.4f train_acc %.3f dev_acc %.3f "
                     "dev_eer %.3f (%.1fs)", epoch, em.train_loss, em.train_acc,
                     em.dev_acc, em.dev_eer, em.seconds)
            if self.ckpt:
                self.ckpt.save(epoch, self.exp, self.state,
                               {"dev_acc": dev_acc, "dev_eer": dev_eer,
                                "train_loss": tm["loss"], "train_acc": tm["acc"],
                                "skipped": tm["skipped"]})
            if plateau is not None:
                # 'min' watches dev EER (train loss without a dev set), 'max'
                # dev accuracy (train accuracy without one)
                if plateau.mode == "max":
                    watch = dev_acc if not np.isnan(dev_acc) else tm["acc"]
                else:
                    watch = dev_eer if not np.isnan(dev_eer) else tm["loss"]
                # written only on a change, so a scale restored from a
                # checkpoint survives the fresh tracker's first epochs
                old_scale = plateau.scale
                new_scale = plateau.update(watch)
                if new_scale != old_scale:
                    self.state.optimizer.plateau_scale = new_scale
                    log.info("plateau: lr scale -> %.4g (watch %.4f)", new_scale, watch)
            stop_value = dev_eer if tc.early_stop_metric == "dev_eer" else dev_acc
            if stopper is not None and not np.isnan(stop_value) and stopper.step(stop_value):
                log.info("early stopping at epoch %d", epoch)
                break
        return self.history


def make_dataset_and_loader(exp: ExperimentConfig, protocol: Protocol, audio_dir: str,
                            shuffle: bool, batch_size: Optional[int] = None,
                            drop_last: bool = True) -> DataLoader:
    ds = AsvspoofDataset(protocol, audio_dir, cut=exp.data.cut, pad_mode=exp.data.pad_mode,
                         sample_rate=exp.data.sample_rate,
                         use_native_io=exp.data.use_native_io,
                         num_workers=exp.data.num_workers)
    return DataLoader(ds, batch_size or exp.train.batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=exp.train.seed, prefetch=exp.data.prefetch)
