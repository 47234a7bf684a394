"""Optimizer and schedules (port of ``adfmsl/train/optim.py``, :23-221).

adfmsl builds one optax chain: global-norm clipping (none when
``grad_clip_norm <= 0``, :181-183), the base optimizer, and for the 'plateau'
scheduler a final scale of the updates that the epoch loop rewrites. The
port's ``Optimizer`` does the same around a ``torch.optim`` optimizer:

- 'adam' is torch's Adam with coupled L2 (``wd * p`` added to the gradient
  before the moments), which is adfmsl's ``add_decayed_weights`` ->
  ``scale_by_adam`` chain (:83-92);
- 'adamw' is torch's AdamW, decoupled decay with the current learning rate,
  as ``optax.adamw`` (:93-96). It decays every parameter, biases, BN scales,
  the sinc band edges and the FMSL temperature included, so the port keeps
  them all in one group;
- 'sgd' is torch's SGD with coupled L2 and heavy-ball momentum, as
  ``optax.sgd`` after ``add_decayed_weights`` (:97-103).

The learning rate of an update is ``schedule(count) * plateau_scale``, where
``count`` counts the updates applied (a skipped step does not advance it, as
optax's schedule count lives in the optimizer state). Clipping is optax's
``clip_by_global_norm``: ``g * max / |g|`` only when ``|g| >= max``.

adfmsl labels each parameter (``param_labels`` :132-166): 'frozen' (optax
``set_to_zero``: no update at all, weight decay included), 'backbone' (the
Wav2Vec2 encoder, at ``lr * backbone_lr_scale``) or 'main'. ``param_labels``
here gives the same labels by the port's parameter names; ``Optimizer``
leaves the 'frozen' parameters out of every ``torch.optim`` group and runs
'backbone' in a group of its own. The global-norm clip is still taken over
every gradient, the frozen ones included, as adfmsl clips before it labels.
A model without an encoder has only 'main'.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from adfmsl_torch.config.base import OptimizerConfig, Wav2Vec2Config

Schedule = Callable[[int], float]


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return schedule


def make_schedule(cfg: OptimizerConfig, steps_per_epoch: int, num_epochs: int) -> Schedule:
    """Learning rate per update count, as optax's schedules give it (adfmsl
    :23-48). 'cosine' and 'step' decay per step, not per epoch."""
    total = max(steps_per_epoch * num_epochs, 1)
    if cfg.scheduler in ("constant", "plateau"):
        return lambda count: cfg.lr
    if cfg.scheduler == "cosine":
        return _cosine_decay(cfg.lr, total, (cfg.min_lr / cfg.lr) if cfg.lr else 0.0)
    if cfg.scheduler == "step":
        bounds = sorted(steps_per_epoch * cfg.step_size * (i + 1)
                        for i in range(max(num_epochs // max(cfg.step_size, 1), 1)))

        def schedule(count: int) -> float:
            v = cfg.lr
            for b in bounds:
                if count >= b:
                    v *= cfg.step_gamma
            return v
        return schedule
    if cfg.scheduler == "warmup_cosine":
        warm = max(cfg.warmup_steps, 1)
        up, down = _linear(0.0, cfg.lr, warm), _cosine_decay(cfg.lr, total - warm)
        return lambda count: up(count) if count < warm else down(count - warm)
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax's global norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def param_labels(w: Wav2Vec2Config, model: torch.nn.Module) -> Dict[str, str]:
    """Parameter name -> 'main', 'backbone' or 'frozen' (adfmsl
    ``_param_label_fn`` :107, ``param_labels`` :143). Outside the
    ``wav2vec2`` encoder: 'main'. With ``unfreeze_last_n`` > 0 only the last
    N encoder layers present (and the feature extractor with
    ``unfreeze_feature_extractor``) are 'backbone', the rest 'frozen';
    otherwise the whole encoder is 'frozen' with ``freeze``, else 'backbone'."""
    names = [n for n, _ in model.named_parameters()]
    layer = re.compile(r"^wav2vec2\.layers_(\d+)\.")
    present = sorted({int(m.group(1)) for m in map(layer.match, names) if m})
    unfrozen = set(present[-w.unfreeze_last_n:]) if w.unfreeze_last_n > 0 else set()
    labels = {}
    for n in names:
        if not n.startswith("wav2vec2."):
            labels[n] = "main"
        elif w.unfreeze_last_n > 0:
            m = layer.match(n)
            train = ((m is not None and int(m.group(1)) in unfrozen)
                     or (w.unfreeze_feature_extractor
                         and n.startswith("wav2vec2.feature_extractor.")))
            labels[n] = "backbone" if train else "frozen"
        else:
            labels[n] = "frozen" if w.freeze else "backbone"
    return labels


class Optimizer:
    """adfmsl's optax chain (``make_optimizer`` :169) over ``params``.
    ``labels`` (one of 'main', 'backbone', 'frozen' a parameter, in the order
    of ``params``; all 'main' when omitted) sets each parameter's group."""

    def __init__(self, cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter],
                 steps_per_epoch: int, num_epochs: int,
                 labels: Optional[Sequence[str]] = None,
                 backbone_lr_scale: float = 1.0):
        self.cfg = cfg
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = make_schedule(cfg, steps_per_epoch, num_epochs)
        self.clip = cfg.grad_clip_norm if cfg.grad_clip_norm and cfg.grad_clip_norm > 0 else 0.0
        self.count = 0
        self.plateau_scale = 1.0
        labels = list(labels) if labels is not None else ["main"] * len(self.params)
        if len(labels) != len(self.params) or set(labels) - {"main", "backbone", "frozen"}:
            raise ValueError(f"bad parameter labels {sorted(set(labels))}")
        groups = [{"params": [p for p, lb in zip(self.params, labels) if lb == group],
                   "lr_scale": scale}
                  for group, scale in (("main", 1.0), ("backbone", backbone_lr_scale))]
        groups = [g for g in groups if g["params"]]   # 'frozen': in no group
        if cfg.name == "adam":
            self.opt = torch.optim.Adam(groups, lr=cfg.lr, weight_decay=cfg.weight_decay)
        elif cfg.name == "adamw":
            self.opt = torch.optim.AdamW(groups, lr=cfg.lr, weight_decay=cfg.weight_decay)
        elif cfg.name == "sgd":
            self.opt = torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                                       weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")

    @classmethod
    def for_model(cls, exp, model: torch.nn.Module, steps_per_epoch: int,
                  num_epochs: Optional[int] = None) -> "Optimizer":
        """The optimizer of ``exp`` over every parameter of ``model``, labelled
        by ``param_labels`` (``exp.train.num_epochs`` when ``num_epochs`` is
        omitted)."""
        labels = param_labels(exp.model.wav2vec2, model)
        params = dict(model.named_parameters())
        ocfg = exp.train.optimizer
        return cls(ocfg, params.values(), steps_per_epoch,
                   exp.train.num_epochs if num_epochs is None else num_epochs,
                   labels=[labels[n] for n in params],
                   backbone_lr_scale=ocfg.backbone_lr_scale)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip_(self, norm: torch.Tensor) -> None:
        """Scale the gradients by ``clip / norm`` where ``norm >= clip``
        (branch-free: no host sync)."""
        if self.clip:
            factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            for p in self.params:
                p.grad.mul_(factor.to(p.grad.dtype))

    def lr(self) -> float:
        return self.schedule(self.count) * self.plateau_scale

    def step(self) -> None:
        """One update from the parameters' ``.grad`` (every parameter needs one:
        optax updates, and AdamW decays, parameters whose gradient is 0)."""
        lr = self.lr()
        for group in self.opt.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"opt": self.opt.state_dict(), "count": self.count,
                "plateau_scale": self.plateau_scale}

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])
        self.plateau_scale = float(state["plateau_scale"])


class PlateauTracker:
    """ReduceLROnPlateau analog (maze3.py:327-374): the epoch loop consults this
    and sets the optimizer's ``plateau_scale``."""

    def __init__(self, patience: int = 2, factor: float = 0.5, mode: str = "min",
                 min_delta: float = 0.0):
        self.patience, self.factor, self.mode = patience, factor, mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad = 0
        self.scale = 1.0

    def update(self, value: float) -> float:
        better = (self.best is None
                  or (self.mode == "min" and value < self.best - self.min_delta)
                  or (self.mode == "max" and value > self.best + self.min_delta))
        if better:
            self.best, self.bad = value, 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale *= self.factor
                self.bad = 0
        return self.scale
