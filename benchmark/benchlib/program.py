"""The system under test, built through the port's own entry points."""
from __future__ import annotations

import time

from benchlib import trace as tr


def set_path(obj, dotted: str, value) -> None:
    *head, last = dotted.split(".")
    for part in head:
        obj = getattr(obj, part)
    setattr(obj, last, value)


def build(cfg: dict, device, eval_kernels: bool):
    """(experiment, model) of the configuration's registry model on
    ``device``, with the evaluate CLI's kernel rule (K1 for the trunk) when
    ``eval_kernels``; the configuration's ``program.overrides`` set first."""
    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import SPECS, build_model

    p = cfg["program"]
    exp = make_experiment(p["model_type"])
    for path, value in p.get("overrides", {}).items():
        set_path(exp, path, value)
    if eval_kernels:
        set_fused_extras(exp, SPECS[p["model_type"]], fused_frontend=False, fused_trunk=True)
    return exp, build_model(exp.model, device=device, seed=0)


class TimedLoader:
    """The loader as its caller sees it, with the host's wait for each batch
    recorded (and, traced, inside a ``bench.loader_wait`` range). ``stop_at``
    (a ``perf_counter`` time) ends an iteration early once reached, and so
    does ``limit`` batches."""

    def __init__(self, loader, traced: bool = False):
        self.loader = loader
        self.traced = traced
        self.waits: list = []
        self.requests: list = []          # each iteration's request times (perf_counter)
        self.stop_at = None
        self.batches: list = []           # the utt ids handed out, when ``keep_ids``
        self.keep_ids = False
        self.limit = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        if name == "loader":
            raise AttributeError(name)
        return getattr(self.loader, name)

    def __iter__(self):
        it = iter(self.loader)
        requests: list = []
        self.requests.append(requests)
        try:
            while True:
                t0 = time.perf_counter()
                requests.append(t0)
                if ((self.stop_at is not None and t0 >= self.stop_at)
                        or (self.limit is not None and len(requests) > self.limit)):
                    return
                with tr.host_range("bench.loader_wait", self.traced):
                    batch = next(it, None)
                if batch is None:
                    return
                self.waits.append(time.perf_counter() - t0)
                if self.keep_ids:
                    self.batches.append(list(batch.utt_ids))
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
