"""Model structure analysis: parameter counts per module, checkpoint
compatibility (port of ``adfmsl/analysis/summary.py``).

Rebuild of the eval scripts' ``analyze_model_structure`` (Maze5_eval.py:227) and
``check_model_compatibility`` (:321 — state-dict key diffing with missing/unexpected
reporting, the load_state_dict(strict=False) workflow at
comprehensive_evaluation.py:411-435).

adfmsl walks a flax ``params`` tree; the port takes a module (its
parameters: BatchNorm's running statistics are buffers, as flax keeps them in
``batch_stats``, outside ``params``) or a mapping of dotted names to tensors.
A module's leaves take flax's names (a Linear's or conv's ``weight`` is
``kernel``, a norm's is ``scale``), so ``model_summary`` prints adfmsl's rows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

_NORMS = (nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm)
_KERNELS = (nn.Linear, nn.modules.conv._ConvNd)

Params = Union[nn.Module, Mapping[str, Any]]


def _flax_leaf(module: nn.Module, name: str) -> str:
    if name == "weight" and isinstance(module, _NORMS):
        return "scale"
    if name == "weight" and isinstance(module, _KERNELS):
        return "kernel"
    return name


def _named_leaves(params: Params) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(params, nn.Module):
        out = []
        for mod_name, mod in params.named_modules():
            for name, p in mod.named_parameters(recurse=False):
                path = tuple(mod_name.split(".")) if mod_name else ()
                out.append((path + (_flax_leaf(mod, name),), p))
        return out
    return [(tuple(k.split(".")), v) for k, v in params.items()]


def _numel(v: Any) -> int:
    return int(np.prod(tuple(v.shape)))


def _nest(params: Params) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in _named_leaves(params):
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = v
    return tree


def count_params(tree: Any) -> int:
    """Parameters of a module, or elements of a mapping's (nested) tensors."""
    if isinstance(tree, nn.Module):
        return sum(_numel(v) for _, v in _named_leaves(tree))
    if isinstance(tree, Mapping):
        return sum(count_params(v) for v in tree.values())
    return _numel(tree)


def model_summary(params: Params, max_depth: int = 2) -> str:
    """Per-module parameter counts, reference analyze_model_structure analog."""
    rows: List[Tuple[str, int]] = []

    def walk(prefix: str, node: Any, depth: int):
        if depth >= max_depth or not isinstance(node, dict):
            rows.append((prefix, count_params(node)))
            return
        for k in sorted(node):
            walk(f"{prefix}/{k}" if prefix else k, node[k], depth + 1)

    tree = _nest(params)
    walk("", tree, 0)
    total = count_params(tree)
    lines = [f"{'module':40s} {'params':>12s}", "-" * 54]
    for name, n in rows:
        lines.append(f"{name:40s} {n:12,d}")
    lines += ["-" * 54, f"{'TOTAL':40s} {total:12,d}"]
    return "\n".join(lines)


def check_compatibility(params: Union[nn.Module, Mapping[str, Any]],
                        restored: Union[nn.Module, Mapping[str, Any]]
                        ) -> Dict[str, List[str]]:
    """Diff two state dicts (or modules' state dicts) by key: missing /
    unexpected / shape-mismatched keys (strict=False load tolerance with
    reporting)."""
    def flat(sd):
        sd = sd.state_dict() if isinstance(sd, torch.nn.Module) else sd
        return {k: tuple(v.shape) for k, v in sd.items()}

    a, b = flat(params), flat(restored)
    return {
        "missing": sorted(set(a) - set(b)),
        "unexpected": sorted(set(b) - set(a)),
        "shape_mismatch": sorted(k for k in set(a) & set(b) if a[k] != b[k]),
    }
