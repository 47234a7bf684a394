"""Scalar metrics log (port of ``adfmsl/utils/metrics_log.py``; the
reference logs through tensorboardX, maze2.py:487-489).

Scalars stream to ``metrics.jsonl`` in the log directory, one ``{"step",
"tag", "value", "wall_time"}`` record a line, appended and line-buffered. A
tensorboardX writer is added when that optional package imports and starts;
nothing depends on it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple


class MetricsLogger:
    def __init__(self, log_dir: str, also_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        if also_tensorboard:
            try:
                from tensorboardX import SummaryWriter  # optional

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"step": int(step), "tag": tag, "value": float(value),
               "wall_time": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.add_scalar(k, v, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def read_metrics(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """The logged scalars: tag -> [(step, value), ...] (a torn line is skipped)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out
