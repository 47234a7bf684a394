"""Per-layer metrics: one reader a metric, ``metrics/<name>.py``, found by name.

A reader defines ``UNIT`` and ``read(ctx)``, which returns the value, or ``None``
where the run gave it nothing to read (the metric is then left out of the
line). A reader that times a module of the model names it in ``STAGES``
(range label: module name); the traced run enters ``stage.<label>`` around
each such module the model has. ``Context`` holds what a run measured: the traced window, the host's
counters and the cell's files.
"""
from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from benchlib.common import BENCH_DIR
from benchlib.trace import Trace


@dataclass
class Context:
    cell: Any
    ref: Any                                     # the configuration's reference module
    trace: Optional[Trace] = None
    window_s: float = 0.0                        # the traced window
    rows: int = 0                                # utterances through the model in it
    calls: int = 0                               # forwards (eval) or steps (train) in it
    loader_waits_s: List[float] = field(default_factory=list)
    timer: Dict[str, float] = field(default_factory=dict)


def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stages(names: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for name in names:
        out.update(getattr(load_reader(name), "STAGES", {}))
    return out


def read_all(names: List[str], ctx: Context) -> Dict[str, dict]:
    out = {}
    for name in names:
        mod = load_reader(name)
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out
