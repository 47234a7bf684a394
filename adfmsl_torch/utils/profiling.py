"""Profiler hooks, the port's spans and counters, and the step timer (port of
``adfmsl/utils/profiling.py``).

``trace`` records the enclosed block with ``torch.profiler`` (CPU and, where
the build has it, CUDA activity) and writes a Chrome trace into the log
directory when the block ends, as adfmsl's ``jax.profiler`` trace does.

``annotate(name, id)`` is the port's one span. With no profiler recording it
costs one check of the profiler's enabled flag and does nothing else. While
one records (``trace``, or any ``torch.profiler.profile`` of the process), it
enters ``record_function(name)``, so the profiler stamps the range on the host
and, around the work it launches, on the device; and it keeps a ``Span``
(name, start, end, the enclosing span on the same thread, ``id``) in memory,
its times in ``time.time_ns()``, the clock the profiler stamps its host
events with. ``id`` is the batch index within a pass, the pass, or the step.

Naming rule: every span is ``stage.<layer>.<part>``, or ``train_step.<part>``
inside the train step (``is_span``). Readers of a profile, the benchmark's
among them, count every other device-side event as a kernel, so a range with
another name that launches device work would be counted as busy time.

``count(name, n)`` adds to an always-on total (``totals``, which the CLIs'
``rank_summary`` line prints) and, while a profiler records, to the recorded
counts. ``recorded()`` returns the recorded spans and counts, ``reset()``
clears them. Nothing is windowed: only the profiled region is recorded.

Counters: ``host_syncs`` (``count_sync``: each call that blocks the host on a
CUDA queue), ``loader.gets``, ``loader.ready`` (the batches the consumer found
queued, summed over its gets) and ``loader.empty_gets``.

``StepTimer`` adds up the host's wall time by phase (the input wait against
the step), which is how an input-bound run shows.
"""
from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function, supported_activities

SPAN_PREFIXES = ("stage.", "train_step.")


def is_span(name: str) -> bool:
    """Whether a profiler event of this name is one of the port's spans (and
    so, on the device side, an annotation rather than a kernel)."""
    return name.startswith(SPAN_PREFIXES)


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


class Span(NamedTuple):
    name: str
    start_ns: int            # time.time_ns(), the profiler's host clock
    end_ns: int
    parent: Optional[str]    # the enclosing span on the same thread
    id: Optional[int]


class Recorded(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]


_spans: List[Span] = []
_counts: Dict[str, int] = {}
_totals: Dict[str, int] = {}
_count_lock = threading.Lock()
_local = threading.local()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "range")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.time_ns()
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)
        _spans.append(Span(self.name, self.start, time.time_ns(), self.parent, self.id))
        _local.stack.pop()


_OFF = contextlib.nullcontext()


def annotate(name: str, id: Optional[int] = None):
    """The span ``name`` around a ``with`` block (see the module's naming rule)."""
    return _Span(name, id) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    recording = _profiler_enabled()
    with _count_lock:
        _totals[name] = _totals.get(name, 0) + n
        if recording:
            _counts[name] = _counts.get(name, 0) + n


def count_sync(t: torch.Tensor, n: int = 1) -> None:
    """Count ``n`` host syncs on ``t``'s CUDA queue (none for a tensor off the card)."""
    if t.is_cuda:
        count("host_syncs", n)


def recorded() -> Recorded:
    """The spans and counts recorded while a profiler ran, since ``reset``."""
    with _count_lock:
        return Recorded(list(_spans), dict(_counts))


def reset() -> None:
    with _count_lock:
        _spans.clear()
        _counts.clear()


def totals() -> Dict[str, int]:
    """Every counter's total since the process started."""
    with _count_lock:
        return dict(_totals)


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
