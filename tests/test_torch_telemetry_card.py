"""On a card: the port's ``host_syncs`` counter against the synchronizing
calls that ``torch.cuda.set_sync_debug_mode("warn")`` reports over the same
work (a ``Trainer`` epoch of maze5_fmsl, two scoring passes through
``produce_scores``), and the spans' clock against the profiler's host and
device events. No JAX here, so the file runs on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_telemetry_card.py -m cuda``.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from adfmsl_torch.utils import profiling

CUT, BATCH, N = 16000, 4, 20
SLACK_NS = 1_000_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the counter counts CUDA syncs only")


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("telemetry_card") / "pack")
    rng = np.random.default_rng(0)
    np.save(prefix + ".npy", (0.1 * rng.standard_normal((N, CUT))).astype(np.float32))
    ids = [f"LA_T_{i:07d}" for i in range(N)]
    with open(prefix + ".json", "w") as fh:
        json.dump({"utt_ids": ids, "cut": CUT, "pad_mode": "tile", "sample_rate": 16000,
                   "labels": {u: int(i % 3 == 0) for i, u in enumerate(ids)}}, fh)
    return prefix


def _syncs(work):
    """(the counter's increase, the syncs the debug mode warned of) over ``work()``."""
    torch.cuda.synchronize()
    before = profiling.totals().get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (set_sync_debug_mode also warns once that it is a prototype: not a sync)
    warned = [w for w in caught if "called a synchronizing" in str(w.message)]
    return profiling.totals().get("host_syncs", 0) - before, len(warned)


@pytest.mark.cuda
def test_host_syncs_count_every_sync_of_a_train_epoch(pack):
    _card()
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import DataLoader, PackedDataset
    from adfmsl_torch.train.loop import Trainer

    exp = make_experiment("maze5_fmsl")
    exp.data.cut = CUT
    exp.train.batch_size, exp.train.log_every_steps = BATCH, 2
    loader = DataLoader(PackedDataset(pack), BATCH, shuffle=True, drop_last=True, prefetch=2)
    trainer = Trainer(exp, loader, device="cuda", persist_config=False)
    trainer.train_epoch(0)                                    # warm-up
    counted, warned = _syncs(lambda: trainer.train_epoch(1))
    steps = N // BATCH
    # at least: the label and mask copies, the guard and the skipped flag a
    # step, the log line's two reads every second step, the epoch's reductions
    assert counted >= 4 * steps + 2 * (steps // 2) + 3
    assert warned == counted


@pytest.mark.cuda
def test_host_syncs_count_every_sync_of_scoring(pack):
    _card()
    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import DataLoader, PackedDataset
    from adfmsl_torch.evaluation import produce_scores
    from adfmsl_torch.models import SPECS, build_model

    exp = make_experiment("maze5_fmsl")
    exp.data.cut = CUT
    set_fused_extras(exp, SPECS["maze5_fmsl"], fused_frontend=False, fused_trunk=True)
    model = build_model(exp.model, device="cuda", seed=0)
    loader = DataLoader(PackedDataset(pack), BATCH, prefetch=2)
    produce_scores(model, loader)                             # warm-up
    counted, warned = _syncs(lambda: [produce_scores(model, loader) for _ in range(2)])
    assert counted >= 2 * (-(-N // BATCH))                    # a copy a batch, in the drain
    assert warned == counted


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_card():
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with profiling.annotate("stage.test.card", i):
                for _ in range(4):
                    x = torch.tanh(x @ x / 1024)
        torch.cuda.synchronize()
    spans = [s for s in profiling.recorded().spans if s.name == "stage.test.card"]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "stage.test.card"]
    host = sorted((e.start_ns(), e.end_ns()) for e in events
                  if e.device_type() != DeviceType.CUDA)
    device = [(e.start_ns(), e.end_ns()) for e in events if e.device_type() == DeviceType.CUDA]
    assert [s.id for s in spans] == [0, 1, 2] and len(host) == 3 and device
    for s, (a, b) in zip(sorted(spans, key=lambda s: s.start_ns), host):
        assert s.start_ns - SLACK_NS <= a <= b <= s.end_ns + SLACK_NS
    # the device runs a span's work after the host entered it
    assert min(a for a, _ in device) >= min(s.start_ns for s in spans) - SLACK_NS
    profiling.reset()
