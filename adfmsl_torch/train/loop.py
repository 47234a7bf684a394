"""The epoch loop (port of ``adfmsl/train/loop.py``: ``Trainer`` :42-295,
``make_dataset_and_loader`` :298).

As adfmsl: the model is built from ``exp.train.seed``; each step draws its
random streams from (seed, epoch, step); metrics accumulate on the device and
reach the host once an epoch; epochs continue across ``fit()`` calls and
after a restore (so streams, shuffles and checkpoint numbers never repeat);
a dev set gives accuracy and EER per epoch, which drive the checkpoint
retention, the plateau scale and early stopping; a Wav2Vec2 model gets its
pretrained encoder from ``wav2vec2.pretrained_path`` before the optimizer is
built, and the optimizer labels its parameters ('main', 'backbone', 'frozen').
``metric_hook`` gets each epoch's ``EpochMetrics`` after its log line and
before its checkpoint; with ``persist_config`` (the default) the config is
written as ``experiment.yaml`` beside the checkpoints, for adfmsl's tools and
the evaluate CLI (every epoch's ``model.pt`` carries it too); ``timer`` adds up
the host's time in the ``input`` wait and the ``train_step`` (its dispatch:
no synchronise is added, as in adfmsl). ``noise_bank`` / ``rir_bank`` (arrays
or tensors, moved to the model's device once) feed the train step's waveform
augmentation when ``exp.data.augment_enabled`` is set (adfmsl :49, :85-86; no
CLI flag passes a bank, as in adfmsl).

With ``mesh`` (``parallel/mesh.py``; one process a rank) the Trainer trains
data-parallel as adfmsl's does under GSPMD: rank 0's weights are broadcast,
each rank takes its row block of every global batch from a loader given
``rank`` / ``world`` (it decodes only those rows; another loader raises), and
the step is the global-batch step of ``train/steps.py`` (sync-BN, global loss).
Dev evaluation scores each rank's rows and gathers the scores into one
global buffer, so every rank computes the same accuracy and EER; the values
that decide the plateau scale and early stopping are rank 0's, broadcast, so
no rank leaves the loop alone and hangs the others in a collective. Rank 0
writes ``experiment.yaml`` and the checkpoints; the others wait at a barrier
after each checkpoint. The banks are rank 0's on every rank (broadcast, as the
weights), and each data rank augments its own rows from its shard's
'augment' stream, as it draws its dropout.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.data.pack import PackedDataset
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
from adfmsl_torch.utils.profiling import StepTimer
from adfmsl_torch.utils.rng import set_global_seed

if TYPE_CHECKING:
    from adfmsl_torch.parallel.mesh import Mesh

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
    means ``cuda``; a missing card raises); under ``mesh``, this rank's part."""

    def __init__(self, exp: ExperimentConfig, train_loader: DataLoader,
                 dev_loader: Optional[DataLoader] = None,
                 checkpoint_dir: Optional[str] = None,
                 metric_hook: Optional[Callable[[EpochMetrics], None]] = None,
                 mesh: Optional["Mesh"] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 persist_config: bool = True, noise_bank=None, rir_bank=None):
        self.exp = exp
        self.mesh = mesh
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        self.metric_hook = metric_hook
        self.device = resolve_device(device)
        set_global_seed(exp.train.seed)
        model = build_model(exp.model, device=self.device, seed=exp.train.seed)
        w2v2 = exp.model.wav2vec2
        if w2v2.pretrained_path or w2v2.require_pretrained:
            inject_pretrained_w2v2(model, w2v2)
        banks = [None if b is None else torch.as_tensor(b, dtype=torch.float32).to(self.device)
                 for b in (noise_bank, rir_bank)]
        if mesh is not None:
            from adfmsl_torch.parallel.mesh import check_loader, replicate

            for loader in (train_loader, dev_loader):
                if loader is not None:
                    check_loader(mesh, loader)
            replicate(mesh, model)
            for b in banks:
                if b is not None:
                    dist.broadcast(b, src=0)
        opt = Optimizer.for_model(exp, model, max(len(train_loader), 1))
        self.state = TrainState(model, opt, exp.train.seed)
        self.train_step = make_train_step(exp, mesh, noise_bank=banks[0], rir_bank=banks[1])
        self.eval_step = make_eval_step()
        self.ckpt = (CheckpointManager(checkpoint_dir, keep_best_k=exp.train.keep_best_k,
                                       metric=exp.train.early_stop_metric,
                                       mode=exp.train.early_stop_mode)
                     if checkpoint_dir else None)
        if checkpoint_dir and persist_config and (mesh is None or mesh.rank == 0):
            # off for an eval-time Trainer: the eval CLI changes exp (the fused
            # extras, the cut) and must not overwrite the training config
            from adfmsl_torch.config.yaml_io import save_yaml

            os.makedirs(checkpoint_dir, exist_ok=True)
            save_yaml(exp, os.path.join(checkpoint_dir, "experiment.yaml"))
        self.history: List[EpochMetrics] = []
        self.epochs_run = 0              # advanced by fit(); restore() sets it
        self.timer = StepTimer()

    def restore(self) -> int:
        """Load the latest checkpoint; the next epoch continues after it."""
        self.state, epoch = self.ckpt.restore(self.state)
        self.epochs_run = epoch + 1
        return epoch

    def _place(self, batch: Batch):
        """Host batch -> device tensors (under the mesh the loader's batch is
        this rank's rows of the global batch, padded to the data axis with
        masked rows)."""
        dev = self.device
        return (torch.from_numpy(batch.audio).to(dev, non_blocking=True),
                torch.from_numpy(batch.label).to(dev).long(),
                torch.from_numpy(batch.mask).to(dev))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        loss_sum = acc_sum = skip_sum = None
        in_s0 = self.timer.totals.get("input", 0.0)
        shard = self.mesh.data_rank if self.mesh is not None else 0
        it = iter(self.train_loader)
        i = 0
        while True:
            with self.timer.phase("input"):
                batch = next(it, None)
            if batch is None:
                break
            with self.timer.phase("train_step"):
                audio, label, mask = self._place(batch)
                m = self.train_step(self.state, audio, label, mask,
                                    self.state.generators(epoch, i, shard))
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
        in_s = self.timer.totals.get("input", 0.0) - in_s0
        if in_s > 0 and i > 0:
            log.info("epoch %d input wait: %.2fs (%.0f utt/s consumer-side)",
                     epoch, in_s, i * self.train_loader.batch_size / in_s)
        return {"loss": float(loss_sum) / n if loss_sum is not None else 0.0,
                "acc": float(acc_sum) / n if acc_sum is not None else 0.0,
                "skipped": int(skip_sum) if skip_sum is not None else 0}

    def evaluate_metrics(self, loader: DataLoader):
        """(accuracy, eer) over a labelled loader; the device results reach
        the host once, after the loop (under the mesh, every rank's rows
        through one ``all_reduce``, so every rank returns the same)."""
        pending = []
        for batch in loader:
            audio, label, mask = self._place(batch)
            out = self.eval_step(self.state, audio, label, mask)
            if self.mesh is None:
                pending.append((out["correct"], out["count"], out["scores"], batch))
            else:
                pred = out["logits"].argmax(dim=-1)
                m = mask.float()
                pending.append(torch.stack([out["scores"].float(), label.float(), m,
                                            (pred == label).float() * m], dim=1))
        if self.mesh is not None:
            return self._mesh_metrics(pending)
        correct = count = 0.0
        scores, labels = [], []
        for dc, dn, ds, batch in pending:
            correct += float(dc)
            count += float(dn)
            s = ds.float().cpu().numpy()
            scores += [float(v) for v, m in zip(s, batch.mask) if m]
            labels += [int(y) for y, m in zip(batch.label, batch.mask) if m]
        return self._metrics(correct, count, scores, labels)

    def _mesh_metrics(self, rows: List[torch.Tensor]):
        from adfmsl_torch.evaluation.runner import gather_rows

        if not rows:
            return self._metrics(0.0, 0.0, [], [])
        g = gather_rows(self.mesh, rows, [len(r) * self.mesh.dp for r in rows])
        real = g[:, 2] > 0
        return self._metrics(float(g[:, 3].sum()), float(g[:, 2].sum()),
                             [float(v) for v in g[real, 0]],
                             [int(round(v)) for v in g[real, 1]])

    @staticmethod
    def _metrics(correct: float, count: float, scores: List[float], labels: List[int]):
        acc = correct / max(count, 1.0)
        eer = float("nan")
        if len(set(labels)) == 2:
            eer, _ = compute_eer(np.asarray(scores), np.asarray(labels))
        return acc, eer

    def fit(self, num_epochs: Optional[int] = None) -> List[EpochMetrics]:
        """``None`` trains up to ``exp.train.num_epochs`` in all (a resumed run
        trains the rest); an explicit count trains that many more."""
        if self.mesh is not None:
            # padded zero rows would enter BatchNorm's batch statistics on every
            # step (the loss is masked, BN is not): refuse instead of padding
            bs = getattr(self.train_loader, "batch_size", self.exp.train.batch_size)
            if bs % self.mesh.dp:
                raise ValueError(f"train batch_size={bs} must be divisible by the "
                                 f"data-parallel axis size {self.mesh.dp}")
            if getattr(self.train_loader, "drop_last", True) is False:
                raise ValueError("mesh training requires drop_last=True on the train "
                                 "loader: a padded partial final batch would pollute "
                                 "BatchNorm batch statistics")
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
            if self.mesh is not None:
                from adfmsl_torch.parallel.mesh import broadcast_floats

                tm["loss"], tm["acc"], dev_acc, dev_eer = broadcast_floats(
                    [tm["loss"], tm["acc"], dev_acc, dev_eer], self.device)
            em = EpochMetrics(epoch, tm["loss"], tm["acc"], dev_acc,
                              time.time() - t0, tm["skipped"], dev_eer)
            self.history.append(em)
            log.info("epoch %d done: loss %.4f train_acc %.3f dev_acc %.3f "
                     "dev_eer %.3f (%.1fs)", epoch, em.train_loss, em.train_acc,
                     em.dev_acc, em.dev_eer, em.seconds)
            if self.metric_hook:
                self.metric_hook(em)
            if self.ckpt:
                if self.mesh is None or self.mesh.rank == 0:
                    self.ckpt.save(epoch, self.exp, self.state,
                                   {"dev_acc": dev_acc, "dev_eer": dev_eer,
                                    "train_loss": tm["loss"], "train_acc": tm["acc"],
                                    "skipped": tm["skipped"]})
                if self.mesh is not None:
                    dist.barrier()
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


def make_dataset_and_loader(exp: ExperimentConfig, protocol: Protocol,
                            audio_dir: Optional[str], shuffle: bool,
                            batch_size: Optional[int] = None,
                            drop_last: bool = True, shard_index: int = 0,
                            num_shards: int = 1, rank: int = 0,
                            world: int = 1, pack: Optional[str] = None) -> DataLoader:
    """The dataset and loader of ``exp`` (``rank`` / ``world``: this data
    rank's row block of each global batch): the audio under ``audio_dir``, or
    with ``pack`` the packed rows of ``{pack}.npy`` (``data/pack.py``; the
    protocol gives the labels), in the same batches."""
    if pack:
        ds = PackedDataset(pack, protocol)
    else:
        ds = AsvspoofDataset(protocol, audio_dir, cut=exp.data.cut,
                             pad_mode=exp.data.pad_mode, sample_rate=exp.data.sample_rate,
                             use_native_io=exp.data.use_native_io,
                             num_workers=exp.data.num_workers)
    return DataLoader(ds, batch_size or exp.train.batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=exp.train.seed, prefetch=exp.data.prefetch,
                      shard_index=shard_index, num_shards=num_shards, rank=rank, world=world)
