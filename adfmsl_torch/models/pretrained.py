"""Pretrained Wav2Vec2 weight injection (port of ``adfmsl/models/pretrained.py``).

The reference downloads ``facebook/wav2vec2-base-960h`` from the hub at model
construction (maze2.py:89-90). Nothing is downloaded here: pretrained weights
arrive as LOCAL files (HF torch .bin / .pt, .safetensors) named by
``Wav2Vec2Config.pretrained_path`` and are loaded into a built model's
``wav2vec2`` encoder. adfmsl's own ``.msgpack`` export (flax serialization of
the encoder's flax tree, which ``python -m adfmsl_torch.cli.convert`` also
writes from a HF checkpoint) is read and written by ``load_native`` /
``save_native`` through ``utils/flax_msgpack.py`` (numpy only), and its tree
becomes the encoder's state dict through ``flax_tree_to_state_dict``.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from adfmsl_torch.config.base import Wav2Vec2Config
from adfmsl_torch.models.w2v2 import arch_for, load_pretrained
from adfmsl_torch.utils import flax_msgpack

log = logging.getLogger(__name__)

__all__ = ["arch_for", "save_native", "load_native", "load_w2v2_params",
           "inject_pretrained_w2v2"]


def save_native(params: Mapping[str, Any], path: str) -> None:
    """Serialize a flax-layout w2v2 param tree (nested dicts of numpy arrays)
    to msgpack: the bytes ``flax.serialization.msgpack_serialize`` writes."""
    with open(path, "wb") as fh:
        fh.write(flax_msgpack.packb(params))


def _restore_into(target: Any, state: Any, path: str = "") -> Any:
    """flax ``from_state_dict`` over dicts: every key of ``target`` must be in
    ``state`` (keys beyond it are dropped); a leaf is taken from ``state``."""
    if not isinstance(target, Mapping):
        return state
    diff = set(map(str, target)).difference(state)
    if diff:
        raise ValueError(
            "The target dict keys and state dict keys do not match, target dict"
            f" contains keys {diff} which are not present in state dict at path"
            f" {path or '.'}")
    return {k: _restore_into(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}


def load_native(path: str, template: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, Any]:
    """Restore a msgpack param tree (adfmsl's flax layout); with ``template``,
    restore INTO its structure, as flax ``from_bytes`` does (a key of the
    template missing from the file raises; leaf shapes are checked by
    ``inject_pretrained_w2v2`` against the built encoder)."""
    with open(path, "rb") as fh:
        tree = flax_msgpack.unpackb(fh.read())
    return _restore_into(template, tree) if template else tree


def load_w2v2_params(path: str, cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """The encoder's state dict from a local checkpoint file: a HF .bin / .pt /
    .safetensors, or a ``.msgpack`` of ``save_native`` or adfmsl's export."""
    if path.endswith(".msgpack"):
        from adfmsl_torch.models.port import flax_tree_to_state_dict

        return flax_tree_to_state_dict(load_native(path))
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
