"""Pretrained Wav2Vec2 weight injection (port of ``adfmsl/models/pretrained.py``).

The reference downloads ``facebook/wav2vec2-base-960h`` from the hub at model
construction (maze2.py:89-90). Nothing is downloaded here: pretrained weights
arrive as LOCAL files (HF torch .bin / .pt, .safetensors) named by
``Wav2Vec2Config.pretrained_path`` and are loaded into a built model's
``wav2vec2`` encoder. adfmsl's own ``.msgpack`` export (flax serialization)
is read by ``convert``, which comes with ROADMAP slice 9.
"""
from __future__ import annotations

import logging
import os
from typing import Dict

import torch
from torch import nn

from adfmsl_torch.config.base import Wav2Vec2Config
from adfmsl_torch.models.w2v2 import arch_for, load_pretrained

log = logging.getLogger(__name__)

__all__ = ["arch_for", "load_w2v2_params", "inject_pretrained_w2v2"]


def load_w2v2_params(path: str, cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from a local checkpoint file."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: adfmsl's msgpack export is read by the convert CLI, which "
            "comes with ROADMAP slice 9; pass the HF .bin / .pt / .safetensors file")
    return load_pretrained(path, arch_for(cfg))


def inject_pretrained_w2v2(model: nn.Module, cfg: Wav2Vec2Config) -> nn.Module:
    """Load ``cfg.pretrained_path`` into ``model.wav2vec2`` (in place; returns
    the model). Shapes are checked against the built encoder and a mismatch
    raises; a missing file raises with ``require_pretrained`` and is skipped
    with a warning without it."""
    path = cfg.pretrained_path
    if not path:
        if cfg.require_pretrained:
            raise FileNotFoundError(
                "wav2vec2.require_pretrained=True but no pretrained_path set")
        return model
    if not os.path.exists(path):
        if cfg.require_pretrained:
            raise FileNotFoundError(f"pretrained checkpoint not found: {path}")
        log.warning("pretrained_path %s missing; using random wav2vec2 init", path)
        return model
    if not hasattr(model, "wav2vec2"):
        log.warning("model has no wav2vec2 encoder; pretrained_path ignored")
        return model
    loaded = load_w2v2_params(path, cfg)
    want = {k: tuple(v.shape) for k, v in model.wav2vec2.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in loaded.items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        mism = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(
            f"pretrained wav2vec2 tree mismatch: missing={missing[:5]} "
            f"extra={extra[:5]} shape_mismatch={mism[:5]}")
    model.wav2vec2.load_state_dict(loaded, strict=True)
    log.info("loaded pretrained wav2vec2 from %s", path)
    return model
