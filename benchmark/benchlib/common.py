"""Cells, configurations and traffic by name; the run's clock, device and result.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names its configuration, traffic and chips, and the manifest's metrics list
the cells that report them; under the benchmark's folder
``workloads/<cell>.json`` holds its correctness limits, ``configs/<config>.json``
the sizes and ``traffic/<traffic>.json`` the parameters the one generator reads.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "adfmsl")   # top-level names, compared whole


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]
    limits: Dict[str, float]
    chips: int = 1


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_cell(name: str, config: Optional[dict] = None, traffic: Optional[dict] = None
              ) -> Cell:
    """The cell ``name`` from the manifest and its files; ``config`` /
    ``traffic`` replace its configuration / traffic (the CPU tests run small
    ones through the same path). A metric without ``workloads`` is reported
    by every cell (an end-to-end one) or by every cell that reports the
    metric it moves (a per-layer one)."""
    m = manifest()
    w = next(x for x in m["workloads"] if x["name"] == name)
    e2e = [e["name"] for e in m["end_to_end"] if name in e.get("workloads", [name])]
    per_layer = [p["name"] for p in m["per_layer"]
                 if name in p.get("workloads", [name] if p["moves"] in e2e else [])]
    cfg = config or load_json("configs", w["config"] + ".json")
    return Cell(name, cfg, traffic or load_json("traffic", w["traffic"] + ".json"),
                e2e, per_layer, dict(load_json("workloads", name + ".json")["correct"]),
                int(w["chips"]))


def process_start_time() -> Optional[float]:
    """The epoch time this process started, from /proc (None where unreadable)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


def set_cache_dirs() -> None:
    """Every cache of the run lives at a fixed path inside the checkout (the
    port's nvcc builds already go to ``adfmsl_torch/_build/``)."""
    cache = os.path.join(BENCH_DIR, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"needs {n} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def card_info() -> dict:
    """The card's name, power limit, SM clock and temperature (nvidia-smi)."""
    keys = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={keys}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(keys.split(","), (v.strip() for v in out[0].split(",")))) if out else {}


def log(*msg) -> None:
    print(*msg, file=sys.stderr, flush=True)


@dataclass
class Result:
    """The run's last line: the contract's keys, the checks last."""
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None

    def emit(self) -> None:
        for name, c in self.checks.items():
            log(f"check {name} {c['value']!r} limit {c['limit']!r}")
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        print(json.dumps(out), flush=True)
