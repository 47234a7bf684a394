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
``isfinite(loss)`` per step. The metrics stay on the device.

With ``train.remat`` the model forward runs through ``ops/remat.py:
checkpoint`` (adfmsl :51, :82-86): the whole forward is recomputed in the
backward, the BN running statistics move once and the generators replay their
draws, so the step's loss, gradients, statistics and generator states are
those of the plain step. The loss stays outside, as in adfmsl.

The step's three parts run under ``torch.profiler.record_function`` labels
(``STEP_LABELS``), so a profile of the real step splits its device time into
forward, backward and update.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch.profiler import record_function

from adfmsl_torch.config.base import ExperimentConfig
from adfmsl_torch.heads.losses import compute_loss, masked_mean
from adfmsl_torch.ops.remat import checkpoint
from adfmsl_torch.train.optim import global_norm
from adfmsl_torch.train.state import TrainState

STEP_LABELS = ("train_step.forward", "train_step.backward", "train_step.update")


def make_train_step(exp: ExperimentConfig) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, audio, labels, mask, rngs) -> metrics``; updates ``state``
    in place. ``audio`` (B, T) f32, ``labels`` (B,) int, ``mask`` (B,) bool,
    all on the model's device; ``rngs`` from ``state.generators``."""
    lcfg = exp.train.loss
    use_remat = exp.train.remat

    def step(state: TrainState, audio: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, rngs: Optional[Mapping[str, torch.Generator]] = None
             ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        with record_function(STEP_LABELS[0]):
            model.train()
            buffers = {k: v.clone() for k, v in model.named_buffers()}
            if use_remat:
                out = checkpoint(model, audio, labels=labels, mask=mask, rngs=rngs,
                                 generators=rngs)
            else:
                out = model(audio, labels=labels, mask=mask, rngs=rngs)
            if "loss" in out:
                loss = out["loss"]
            else:
                loss = compute_loss(lcfg.name, out["logits"], labels,
                                    class_weights=lcfg.class_weights,
                                    focal_alpha=lcfg.focal_alpha,
                                    focal_gamma=lcfg.focal_gamma, mask=mask)
        with record_function(STEP_LABELS[1]):
            opt.zero_grad()
            loss.backward()
            for p in opt.params:
                if p.grad is None:        # a leaf the loss does not reach: 0, as in JAX
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.masked_fill_(~torch.isfinite(p.grad), 0.0)
            grad_norm = global_norm(p.grad for p in opt.params)
        with record_function(STEP_LABELS[2]):
            good = bool(torch.isfinite(loss))       # the step's one host sync
            if good:
                opt.clip_(grad_norm)
                opt.step()
            else:
                with torch.no_grad():
                    for k, v in model.named_buffers():
                        v.copy_(buffers[k])
            state.step += 1
            with torch.no_grad():
                pred = out["logits"].argmax(dim=-1)
                acc = masked_mean((pred == labels).float(), mask)
                loss_out = (loss.detach().float() if good
                            else torch.zeros((), device=loss.device))
        return {"loss": loss_out, "acc": acc,
                "skipped": torch.tensor(0.0 if good else 1.0, device=loss.device),
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
