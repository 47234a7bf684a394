"""The port's spans and counters (``adfmsl_torch/utils/profiling.py``).

With no profiler recording, ``annotate`` enters no ``record_function`` and
keeps nothing. Under a CPU ``torch.profiler.profile`` each kept span encloses
the profiler's host event of the same name to within 1 ms (the shared clock),
with its parent and id; counters add up, also across threads. Then the places
the program enters them: ``produce_scores`` over a small pack gives one
``stage.runner.drain`` a pass and one ``stage.loader.get`` a batch, with the
model's three stages and K1's weight folding a forward; two ``Trainer`` steps
give one ``train_step.place`` and one ``train_step.guard_sync`` a step; every
range the port enters in those runs is named by the naming rule; and
``host_syncs`` reads 0 on the CPU. ``check_model_stages`` is the check the
model families' test files run on one forward of each model: its front-end,
trunk and head spans, once each and in order.
"""
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adfmsl_torch.utils import profiling

CUT, BATCH, N = 4000, 4, 8
SLACK_NS = 1_000_000


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _ranges(prof):
    """Every user range the profiler saw: (name, start ns, end ns)."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


MODEL_STAGES = ("stage.model.frontend", "stage.model.trunk", "stage.model.head")


def check_model_stages(model, x, names=MODEL_STAGES):
    """One eval forward of ``model`` on ``x`` under a CPU profiler enters each
    of ``names`` once, in that order, one after another, inside no other span;
    and no other ``stage.model.*`` span."""
    profiling.reset()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        model(x)
    spans = sorted((s for s in profiling.recorded().spans if s.name.startswith("stage.model.")),
                   key=lambda s: s.start_ns)
    profiling.reset()
    assert [s.name for s in spans] == list(names)
    assert all(s.parent is None for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_annotate_without_a_profiler_enters_no_range_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function", lambda name: entered.append(name))
    before = profiling.totals()
    with profiling.annotate("stage.test.off", 3) as span:
        profiling.count("test.off", 2)
    assert span is None and entered == []
    assert profiling.recorded() == ([], {})
    assert profiling.totals()["test.off"] == before.get("test.off", 0) + 2


def test_span_intervals_enclose_the_profilers_events_on_one_clock():
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.annotate("stage.test.outer", i):
                with profiling.annotate("stage.test.inner"):
                    x = x @ torch.ones(64, 64) / 64
    spans = profiling.recorded().spans
    assert Counter(s.name for s in spans) == {"stage.test.outer": 3, "stage.test.inner": 3}
    assert [(s.parent, s.id) for s in spans if s.name == "stage.test.inner"] == [
        ("stage.test.outer", None)] * 3
    assert [(s.parent, s.id) for s in spans if s.name == "stage.test.outer"] == [
        (None, 0), (None, 1), (None, 2)]
    events = sorted(_ranges(prof), key=lambda e: e[1])
    for name in ("stage.test.outer", "stage.test.inner"):
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = [(a, b) for n, a, b in events if n == name]
        assert len(theirs) == len(mine)
        for (s, e), (a, b) in zip(mine, theirs):
            assert s - SLACK_NS <= a <= b <= e + SLACK_NS and s <= e


def test_counters_add_up_and_are_recorded_only_while_profiling():
    before = profiling.totals()
    profiling.count("test.c", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.c")
        profiling.count("test.c", 5)
        profiling.count_sync(torch.zeros(2), 7)          # not a CUDA tensor: no sync
    profiling.count("test.c", 11)
    assert profiling.totals()["test.c"] == before.get("test.c", 0) + 20
    assert profiling.recorded().counts == {"test.c": 6}
    assert profiling.totals().get("host_syncs", 0) == before.get("host_syncs", 0)
    profiling.reset()
    assert profiling.recorded() == ([], {})


def test_counters_lose_no_update_across_threads():
    n_threads, per = 16, 2000
    before = profiling.totals().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("test.threads")
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.totals()["test.threads"] == before + n_threads * per


@pytest.mark.parametrize("name,span", [("stage.model.trunk", True), ("train_step.place", True),
                                       ("stage.trunk", True), ("bench.loader_wait", False),
                                       ("aten::mm", False), ("resblock_eval_kernel", False)])
def test_is_span(name, span):
    assert profiling.is_span(name) is span


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("telemetry") / "pack")
    rng = np.random.default_rng(0)
    np.save(prefix + ".npy", (0.1 * rng.standard_normal((N, CUT))).astype(np.float32))
    ids = [f"LA_T_{i:07d}" for i in range(N)]
    with open(prefix + ".json", "w") as fh:
        json.dump({"utt_ids": ids, "cut": CUT, "pad_mode": "tile", "sample_rate": 16000,
                   "labels": {u: i % 2 for i, u in enumerate(ids)}}, fh)
    return prefix


def _check_names(prof):
    """The ranges the port entered (torch.optim enters its own
    ``Optimizer.step#AdamW.step``) all follow the naming rule."""
    names = {n for n, _, _ in _ranges(prof) if not n.startswith("Optimizer.")}
    assert names and all(profiling.is_span(n) for n in names), sorted(names)
    return names


@pytest.mark.parametrize("prefetch", [0, 2])
def test_produce_scores_spans_a_drain_a_pass_and_a_get_a_batch(pack, prefetch):
    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import DataLoader, PackedDataset
    from adfmsl_torch.evaluation import produce_scores
    from adfmsl_torch.models import SPECS, build_model

    exp = make_experiment("maze5")
    exp.data.cut = CUT
    set_fused_extras(exp, SPECS["maze5"], fused_frontend=False, fused_trunk=True)
    model = build_model(exp.model, device="cpu", seed=0)
    loader = DataLoader(PackedDataset(pack), BATCH, prefetch=prefetch)
    before = profiling.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = [produce_scores(model, loader) for _ in range(2)]
    assert all(len(r.utt_ids) == N for r in results)
    spans = profiling.recorded().spans
    batches = 2 * N // BATCH
    assert Counter(s.name for s in spans) == {
        "stage.runner.drain": 2, "stage.loader.get": batches, "stage.model.frontend": batches,
        "stage.model.trunk": batches, "stage.model.head": batches,
        "stage.k1.weights": batches * 5}                  # maze5's five blocks fold
    assert [s.id for s in spans if s.name == "stage.runner.drain"] == [0, 1]
    assert [s.id for s in spans if s.name == "stage.loader.get"] == [0, 1, 0, 1]
    assert {s.parent for s in spans if s.name == "stage.k1.weights"} == {"stage.model.trunk"}
    assert {s.parent for s in spans if s.name.startswith("stage.model.")} == {None}
    counts = profiling.recorded().counts
    assert counts["loader.gets"] == batches and "host_syncs" not in counts
    empty = counts.get("loader.empty_gets", 0)
    if prefetch == 0:                        # no queue: every get makes its batch
        assert counts["loader.ready"] == 0 and empty == batches
    else:
        assert counts["loader.ready"] <= prefetch * batches and empty <= batches
    assert profiling.totals()["loader.gets"] == before.get("loader.gets", 0) + batches
    assert _check_names(prof) == {s.name for s in spans}


def test_trainer_steps_give_a_place_and_a_guard_sync_a_step(pack):
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import DataLoader, PackedDataset
    from adfmsl_torch.train.loop import Trainer
    from adfmsl_torch.train.steps import STEP_LABELS

    exp = make_experiment("maze5")
    exp.data.cut, exp.model.dtype = CUT, "float32"
    exp.train.batch_size, exp.train.log_every_steps = BATCH, 1
    loader = DataLoader(PackedDataset(pack), BATCH, shuffle=True, drop_last=True, prefetch=2)
    trainer = Trainer(exp, loader, device="cpu", persist_config=False)
    before = profiling.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(0)
    steps = N // BATCH
    spans = profiling.recorded().spans
    names = Counter(s.name for s in spans)
    assert {k: names[k] for k in ("train_step.place", "train_step.guard_sync",
                                  *STEP_LABELS)} == {k: steps for k in (
        "train_step.place", "train_step.guard_sync", *STEP_LABELS)}
    assert [s.id for s in spans if s.name == "train_step.place"] == list(range(steps))
    assert [(s.parent, s.id) for s in spans if s.name == "train_step.guard_sync"] == [
        ("train_step.update", i) for i in range(steps)]
    assert {s.parent for s in spans if s.name.startswith("stage.model.")} == {
        "train_step.forward"}
    assert names["stage.loader.get"] == steps and "stage.k1.weights" not in names
    assert profiling.totals().get("host_syncs", 0) == before.get("host_syncs", 0) == 0
    assert "host_syncs" not in profiling.recorded().counts
    assert _check_names(prof) == set(names)
