"""The readers of the program's own spans and counters on a synthetic
``readers.Context``: the device-side ones read the kernels inside a span's
device-side intervals, the host-side ones read
``adfmsl_torch.utils.profiling.recorded()``, and every one reads nothing
from a program that lacks the span or counter (the parent of the change that
added them)."""
import pytest

from benchlib import readers
from benchlib.trace import Trace

from adfmsl_torch.utils import profiling
from adfmsl_torch.utils.profiling import Recorded, Span

DEVICE = {"model_frontend_ms.eval": "stage.model.frontend",
          "model_trunk_ms.eval": "stage.model.trunk",
          "model_head_ms.eval": "stage.model.head",
          "k1_weights_ms.eval": "stage.k1.weights"}
HOST = ("loader_get_ms.eval", "loader_queue_depth.eval", "drain_idle_ms.eval",
        "loader_idle_ms.eval", "train_place_ms", "train_guard_sync_ms",
        "host_syncs_per_step.train")


def _span(name, start_us, end_us, id=None, parent=None):
    return Span(name, int(start_us * 1e3), int(end_us * 1e3), parent, id)


@pytest.fixture
def trace():
    """Kernels at 0-10, 20-50 (two overlapping), 60-70 and 200-300 us."""
    return Trace(kernels=[(0.0, 10.0, "a"), (20.0, 40.0, "b"), (30.0, 50.0, "c"),
                          (60.0, 70.0, "d"), (200.0, 300.0, "e")])


@pytest.fixture
def forward(monkeypatch):
    """A forward's program spans as the host recorded them: the model's three
    stages, K1's weight folding inside the trunk."""
    spans = [_span("stage.model.frontend", 0, 10), _span("stage.model.trunk", 10, 20),
             _span("stage.k1.weights", 12, 13, parent="stage.model.trunk"),
             _span("stage.model.head", 20, 30)]
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded(spans, {}))


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_device_readers_take_the_kernels_inside_their_span(name, trace, forward):
    trace.device_spans[DEVICE[name]] = [(15.0, 45.0), (40.0, 65.0), (250.0, 400.0)]
    trace.device_spans["stage.other"] = [(0.0, 300.0)]
    ctx = readers.Context(cell=None, ref=None, trace=trace, calls=2)
    # 20-50 and 60-65 and 250-300: 85 us over two forwards
    assert readers.read_all([name], ctx) == {name: {"value": pytest.approx(0.0425),
                                                    "unit": "ms"}}


def test_a_stage_takes_the_kernels_of_the_ranges_inside_it(trace, forward):
    """The profiler gives a kernel to the innermost open range: the trunk's
    kernels sit under the benchmark's ``stage.trunk`` hook and K1's weight
    folding, none under ``stage.model.trunk`` itself."""
    trace.device_spans.update({"stage.trunk": [(18.0, 52.0)],
                               "stage.k1.weights": [(58.0, 72.0)],
                               "stage.sinc_frontend": [(0.0, 12.0)],
                               "stage.model.frontend": [(195.0, 205.0)],
                               "stage.model.head": [(205.0, 300.0)]})
    ctx = readers.Context(cell=None, ref=None, trace=trace, calls=1)
    got = {k: v["value"] for k, v in readers.read_all(sorted(DEVICE), ctx).items()}
    assert got == pytest.approx({"model_trunk_ms.eval": 0.040,     # 20-50, 60-70
                                 "k1_weights_ms.eval": 0.010,      # 60-70
                                 "model_frontend_ms.eval": 0.015,  # 0-10, 200-205
                                 "model_head_ms.eval": 0.095})     # 205-300


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_device_readers_read_nothing_without_their_span(name, trace, monkeypatch):
    """The parent's program records no span and has no ``recorded``; the
    benchmark's own hooks alone give the model's stages nothing."""
    trace.device_spans.update({"stage.trunk": [(0.0, 300.0)],
                               "stage.sinc_frontend": [(0.0, 300.0)]})
    ctx = readers.Context(cell=None, ref=None, trace=trace, calls=2)
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}))
    assert readers.read_all([name], ctx) == {}
    monkeypatch.delattr(profiling, "recorded")
    assert readers.read_all([name], ctx) == {}


@pytest.fixture
def program(monkeypatch):
    """Two passes of two gets and a drain each, two train steps, and the
    counters of such a run."""
    spans = [_span("stage.loader.get", 0, 15, 0), _span("stage.loader.get", 55, 60, 1),
             _span("stage.runner.drain", 70, 110, 0),
             _span("stage.loader.get", 110, 150, 0), _span("stage.loader.get", 150, 210, 1),
             _span("stage.runner.drain", 300, 320, 1),
             _span("train_step.place", 400, 401.5, 0),
             _span("train_step.guard_sync", 405, 408, 0, "train_step.update"),
             _span("train_step.place", 500, 500.5, 1),
             _span("train_step.guard_sync", 505, 512, 1, "train_step.update")]
    counts = {"loader.gets": 4, "loader.ready": 10, "loader.empty_gets": 1, "host_syncs": 9}
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded(spans, counts))


def test_host_readers_read_the_recorded_spans_and_counts(program, trace):
    eval_ctx = readers.Context(cell=None, ref=None, trace=trace, calls=4)
    got = {k: v["value"] for k, v in readers.read_all(list(HOST[:4]), eval_ctx).items()}
    assert got == pytest.approx({
        "loader_get_ms.eval": 0.030,            # (15 + 5 + 40 + 60) us over 4 gets
        "loader_queue_depth.eval": 2.5,         # 10 ready over 4 gets
        # the drains' 40 + 20 us with nothing on the device, over 2 passes
        "drain_idle_ms.eval": 0.030,
        # the gets' 120 us less the kernels inside (0-10, 200-210), over 2 passes
        "loader_idle_ms.eval": 0.050})
    train_ctx = readers.Context(cell=None, ref=None, trace=trace, calls=2)
    got = {k: v["value"] for k, v in readers.read_all(list(HOST[4:]), train_ctx).items()}
    assert got == pytest.approx({"train_place_ms": 0.001, "train_guard_sync_ms": 0.005,
                                 "host_syncs_per_step.train": 4.5})


def test_host_readers_read_nothing_from_a_program_without_them(monkeypatch, trace):
    ctx = readers.Context(cell=None, ref=None, trace=trace, calls=4)
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}))
    assert readers.read_all(list(HOST), ctx) == {}
    monkeypatch.delattr(profiling, "recorded")          # the parent's profiling module
    assert readers.read_all(list(HOST), ctx) == {}
