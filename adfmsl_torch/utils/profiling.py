"""Profiler hooks and the step timer (port of ``adfmsl/utils/profiling.py``).

``trace`` records the enclosed block with ``torch.profiler`` (CPU and, where
the build has it, CUDA activity) and writes a Chrome trace into the log
directory when the block ends, as adfmsl's ``jax.profiler`` trace does.
``annotate`` names a region of that timeline. ``StepTimer`` adds up the host's
wall time by phase (the input wait against the step), which is how an
input-bound run shows.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

from torch.profiler import ProfilerActivity, profile, record_function, supported_activities


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block; at its end write
    ``log_dir/<host>_<pid>.pt.trace.json`` (one file a process, so ranks do
    not collide), the format TensorBoard's profiler plugin and Perfetto read."""
    wanted = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    with profile(activities=[a for a in wanted if a in supported_activities()]) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json"))


def annotate(name: str) -> record_function:
    """A named region that shows in the profiler's timeline."""
    return record_function(name)


@dataclass
class StepTimer:
    """Accumulates the host's wall time per phase (e.g. the input wait
    against the train step)."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1e3, 3),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        lines = ["phase             total(s)   count   mean(ms)"]
        for name, s in self.summary().items():
            lines.append(f"{name:16s} {s['total_s']:9.3f} {s['count']:7d} "
                         f"{s['mean_ms']:10.3f}")
        return "\n".join(lines)
