"""Train and eval steps (port of ``adfmsl/train/steps.py``, :29-147).

One train step: forward in train mode with labels and mask, the loss (the
model's own for FMSL modes 'replace' / 'integrated', else
``LossConfig``-dispatched), backward, then adfmsl's non-finite guard (:98-119):

- non-finite gradient elements are zeroed first;
- ``grad_norm`` is taken on those zeroed, unclipped gradients;
- a non-finite loss keeps the whole old state (parameters, BN running
  statistics, optimizer moments and counts); the step counter still advances.

adfmsl decides that with a select on the device. The forward here updates the
BN buffers in place, so they are snapshotted first (a few KB) and restored on
a skip, and the update is skipped: that takes one host sync on
``isfinite(loss)`` per step (``train_step.guard_sync``), and the ``skipped``
flag's copy to the device another; both count in ``host_syncs``
(``utils/profiling.py``). The other metrics stay on the device.

With ``train.remat`` the model forward runs through ``ops/remat.py:
checkpoint`` (adfmsl :51, :82-86): the whole forward is recomputed in the
backward, the BN running statistics move once and the generators replay their
draws, so the step's loss, gradients, statistics and generator states are
those of the plain step. The loss stays outside, as in adfmsl.

With ``exp.data.augment_enabled`` and a noise or RIR bank (adfmsl :53-54,
:66-71), the step first augments ``audio`` (``data/augment.py:
augment_waveform``, from ``rngs['augment']``) under ``no_grad``, before the
forward and outside ``train.remat``'s checkpoint, so a recompute never
draws again; every later part of the step sees the augmented audio.

The step's three parts run under the port's spans (``STEP_LABELS``,
``utils/profiling.py:annotate``, their id the step), so a profile of the real
step splits its device time into forward, backward and update.

With a ``mesh`` (``parallel/mesh.py``) each rank takes its row block of the
global batch, and the step is adfmsl's global-batch (GSPMD) step:

- BatchNorm normalises over the global batch (``ops/norm.py:bn_train``);
- an external loss is ``loss_parts``' global numerator over its global
  denominator: the denominator is summed over the data group before the
  backward, each rank differentiates its numerator over it, and the
  gradients are summed in one flat ``all_reduce`` (``shard_map_step.py``
  :79-84's arithmetic; the ranks' roots add up to the global loss);
- a model-internal loss (the FMSL head) is already global on every rank, so
  each rank's root is it over the data ranks;
- accuracy is the global correct count over the global count.

The guard, the clip and the update then run on the global gradients, which
every rank holds alike, as it holds the loss; so the ranks never diverge.
With tensor-parallel Wav2Vec2 layers (``parallel/tp.py``) the gradient norm
adds the sharded parameters' squares over the model group. With
``local_bn`` the statistics stay the rank's own and are averaged after the
step (``parallel/shard_map_step.py``). At one rank the step is the plain
step, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.data.augment import augment_waveform
from adfmsl_torch.heads.losses import compute_loss, loss_parts, masked_mean
from adfmsl_torch.ops.remat import checkpoint
from adfmsl_torch.parallel.collectives import all_reduce_flat, data_parallel
from adfmsl_torch.train.optim import global_norm
from adfmsl_torch.train.state import TrainState
from adfmsl_torch.utils.profiling import annotate, count_sync

STEP_LABELS = ("train_step.forward", "train_step.backward", "train_step.update")


def grad_global_norm(params, mesh=None) -> torch.Tensor:
    """optax's global norm of the gradients; the squares of tensor-parallel
    shards (``parallel/tp.py`` marks them ``tp_dim``) are summed over the
    model group."""
    if mesh is None or mesh.mp == 1:
        return global_norm(p.grad for p in params)
    sharded = [p.grad for p in params if getattr(p, "tp_dim", None) is not None]
    whole = [p.grad for p in params if getattr(p, "tp_dim", None) is None]
    sq = global_norm(sharded) ** 2 if sharded else torch.zeros((), device=params[0].device)
    dist.all_reduce(sq, group=mesh.model_group)
    return torch.sqrt(global_norm(whole) ** 2 + sq)


def make_train_step(exp: ExperimentConfig, mesh=None, local_bn: bool = False,
                    noise_bank: Optional[torch.Tensor] = None,
                    rir_bank: Optional[torch.Tensor] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, audio, labels, mask, rngs) -> metrics``; updates ``state``
    in place. ``audio`` (B, T) f32, ``labels`` (B,) int, ``mask`` (B,) bool,
    all on the model's device (under ``mesh``: this rank's rows); ``rngs``
    from ``state.generators``. ``noise_bank`` (N, T) and ``rir_bank`` (R, L)
    lie on the model's device; they augment only with
    ``exp.data.augment_enabled``."""
    lcfg = exp.train.loss
    use_remat = exp.train.remat
    group = mesh.data_group if mesh is not None else None
    dp = mesh.dp if mesh is not None else 1
    dcfg = exp.data
    augment = dcfg.augment_enabled and (noise_bank is not None or rir_bank is not None)

    def step(state: TrainState, audio: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, rngs: Optional[Mapping[str, torch.Generator]] = None
             ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if augment:
            if rngs is None:
                raise ValueError("an augmenting train step draws from rngs['augment']")
            with torch.no_grad():
                audio = augment_waveform(audio, rngs["augment"], noise_bank, rir_bank,
                                         dcfg.augment_noise_prob, dcfg.augment_reverb_prob,
                                         dcfg.augment_snr_db_min, dcfg.augment_snr_db_max)
        with data_parallel(None if local_bn else group):
            with annotate(STEP_LABELS[0], state.step):
                model.train()
                buffers = {k: v.clone() for k, v in model.named_buffers()}
                if use_remat:
                    out = checkpoint(model, audio, labels=labels, mask=mask, rngs=rngs,
                                     generators=rngs)
                else:
                    out = model(audio, labels=labels, mask=mask, rngs=rngs)
                with torch.no_grad():
                    pred = out["logits"].argmax(dim=-1)
                if mesh is None:
                    acc = masked_mean((pred == labels).float(), mask)
                    if "loss" in out:
                        loss = root = out["loss"]
                    else:
                        loss = root = compute_loss(
                            lcfg.name, out["logits"], labels,
                            class_weights=lcfg.class_weights, focal_alpha=lcfg.focal_alpha,
                            focal_gamma=lcfg.focal_gamma, mask=mask)
                else:
                    internal = "loss" in out
                    if internal:
                        num, denom = out["loss"], torch.ones_like(out["loss"])
                    else:
                        num, denom = loss_parts(
                            lcfg.name, out["logits"], labels,
                            class_weights=lcfg.class_weights, focal_alpha=lcfg.focal_alpha,
                            focal_gamma=lcfg.focal_gamma, mask=mask)
                    m = mask.float()
                    sums = torch.stack([num.detach().float(), denom.detach().float(),
                                        ((pred == labels).float() * m).sum(), m.sum()])
                    dist.all_reduce(sums, group=group)
                    acc = sums[2] / torch.clamp(sums[3], min=1.0)
                    if internal and not local_bn:
                        # global already (heads/fmsl.py): each rank's root is a share
                        loss, root = out["loss"].detach(), out["loss"] / dp
                    elif internal:
                        # the shards' own losses: their mean, and the mean gradient
                        loss, root = sums[0] / dp, out["loss"] / dp
                    else:
                        gden = torch.clamp(sums[1], min=1e-8)
                        loss, root = sums[0] / gden, num / gden
            with annotate(STEP_LABELS[1], state.step):
                opt.zero_grad()
                root.backward()
                for p in opt.params:
                    if p.grad is None:    # a leaf the loss does not reach: 0, as in JAX
                        p.grad = torch.zeros_like(p)
                if mesh is not None:
                    all_reduce_flat([p.grad for p in opt.params], group)
                for p in opt.params:
                    p.grad.masked_fill_(~torch.isfinite(p.grad), 0.0)
                grad_norm = grad_global_norm(opt.params, mesh)
        with annotate(STEP_LABELS[2], state.step):
            finite = torch.isfinite(loss)
            # the span holds the sync alone: the profiler gives a kernel to the
            # innermost open range, and the update's device span starts at the
            # isfinite kernel
            with annotate("train_step.guard_sync", state.step):
                good = bool(finite)                 # the guard's host sync
            count_sync(loss)
            if good:
                opt.clip_(grad_norm)
                opt.step()
                if local_bn:
                    # the shards' running statistics, averaged (adfmsl's pmean)
                    stats = [v for k, v in model.named_buffers()
                             if k.endswith(("running_mean", "running_var"))]
                    all_reduce_flat(stats, group)
                    for v in stats:
                        v.div_(dp)
            else:
                with torch.no_grad():
                    for k, v in model.named_buffers():
                        v.copy_(buffers[k])
            state.step += 1
            loss_out = (loss.detach().float() if good
                        else torch.zeros((), device=loss.device))
        skipped = torch.tensor(0.0 if good else 1.0, device=loss.device)   # a blocking copy
        count_sync(skipped)
        return {"loss": loss_out, "acc": acc, "skipped": skipped,
                "grad_norm": grad_norm.detach()}

    return step


def make_eval_step() -> Callable[..., Dict[str, torch.Tensor]]:
    """Batched inference in eval mode: scores, logits and the accuracy counts
    under the validity mask."""

    def step(state: TrainState, audio: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.inference_mode():
            out = model(audio)
            pred = out["logits"].argmax(dim=-1)
            m = mask.float()
            return {"scores": out["scores"], "logits": out["logits"],
                    "correct": ((pred == labels).float() * m).sum(), "count": m.sum()}

    return step
