"""The traced run: ranges the benchmark enters around the program's layers,
the profiler's device events, and their reduction.

Stage ranges are ``record_function('stage.<label>')`` entered and left by
forward hooks on the modules the cell's metric readers name (``STAGES``). A stage's device
time is the union of the kernel intervals that fall inside its device-side
spans (the profiler may emit several overlapping spans for one range, and a
span also holds the gaps between its kernels); the device's busy time is the
union of all kernel intervals, so concurrent kernels count once. This is the
method of ``adfmsl_torch/profile_eval.py``, copied.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def merged(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped_union_us(kernels: List[Interval], spans: List[Interval]) -> float:
    """Union of the parts of ``kernels`` inside ``spans``."""
    spans = merged(spans)
    starts = [a for a, _ in spans]
    parts = []
    for s, e in kernels:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(spans) and spans[i][0] < e:
            a, b = spans[i]
            if b > s:
                parts.append((max(s, a), min(e, b)))
            i += 1
    return union_us(parts)


def stage_hooks(model, stages: Dict[str, str]):
    """Enter ``stage.<label>`` around each named module's forward (those the
    model has); returns the hook handles."""
    from torch.profiler import record_function

    mods = dict(model.named_modules())
    open_ranges, handles = {}, []
    for label, mname in stages.items():
        if mname not in mods:
            continue
        def pre(_m, _a, label=label):
            open_ranges[label] = record_function(f"stage.{label}")
            open_ranges[label].__enter__()

        def post(_m, _a, _o, label=label):
            open_ranges.pop(label).__exit__(None, None, None)
        handles += [mods[mname].register_forward_pre_hook(pre),
                    mods[mname].register_forward_hook(post)]
    return handles


@dataclass
class Trace:
    """What the readers see of the traced window (times in microseconds)."""
    kernels: List[Tuple[float, float, str]] = field(default_factory=list)
    device_spans: Dict[str, List[Interval]] = field(default_factory=dict)
    host_ranges: Dict[str, List[Interval]] = field(default_factory=dict)

    def kernel_intervals(self, contains=None) -> List[Interval]:
        return [(s, e) for s, e, n in self.kernels
                if contains is None or any(c in n for c in contains)]

    def busy_us(self) -> float:
        return union_us(self.kernel_intervals())


def collect(prof, host_prefixes=("bench.", "train_step.")) -> Trace:
    """The kernels, the device-side spans of the benchmark's and the train
    step's ranges, and their host ranges, from a finished
    ``torch.profiler.profile`` (its raw events: building the profiler's
    event tree would take minutes for a long window)."""
    from torch.autograd import DeviceType

    tr = Trace()
    spans = ("stage.", "train_step.", "bench.")
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(spans):
                tr.device_spans.setdefault(name, []).append((s, t))
            else:
                tr.kernels.append((s, t, name))
        elif name.startswith(host_prefixes):
            tr.host_ranges.setdefault(name, []).append((s, t))
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    labelled by the innermost host range that holds each gap's middle."""
    by_name: Dict[str, float] = {}
    for s, e, n in tr.kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(tr.kernel_intervals())
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        best, width = "none", None
        for name, ranges in tr.host_ranges.items():
            for s, e in ranges:
                if s <= mid <= e and (width is None or e - s < width):
                    best, width = name, e - s
        labelled.append([best, (b - a) / 1e6])
    return {"device_ops": [[n[:120], t / 1e6] for n, t in ops], "idle_gaps": labelled}


@contextlib.contextmanager
def host_range(name: str, on: bool):
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
