"""The port's utilities (``adfmsl_torch/utils``) against adfmsl's, and the
train CLI's ``--config`` / ``--log_dir`` / ``--profile_dir`` on the CPU.

``MetricsLogger`` / ``read_metrics`` and ``StepTimer`` run the sequences of
tests/test_analysis.py:83 and tests/test_train_extras.py:45 in both packages;
the registry holds adfmsl's model names and raises as adfmsl's does;
``set_global_seed`` leaves numpy's and Python's generators where adfmsl's
does; ``trace`` writes a Chrome trace holding an ``annotate`` region. Then
one epoch of maze5 through ``cli.train --config`` at cut 4000, batch 4, on
the synthetic fixture of tests/test_torch_train_cli.py (12 train, 8 dev and
8 eval utterances): ``metrics.jsonl`` holds adfmsl's tags at step 0 with the
checkpoint's own values, ``experiment.yaml`` loads in adfmsl to the tree the
run used, the trace holds the train step's labels, an ``--eval`` run leaves
``experiment.yaml`` as it was, and ``cli.evaluate --model_path`` takes its
config from ``experiment.yaml`` (and from ``model.pt`` without it) to the
same score file. ``cli.evaluate --profile_dir`` writes a Chrome trace that
holds the port's spans: one drain a pass, a loader get, the model's three
stages a batch, and K1's weight folding a block.
"""
import dataclasses
import glob
import json
import os
import random

import numpy as np
import pytest
import torch

from adfmsl_torch.data import SyntheticSpec, generate_fixture
from adfmsl_torch.utils import (MetricsLogger, Registry, StepTimer, annotate, read_metrics,
                                set_global_seed, trace)

CUT, BATCH = 4000, 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _log_sequence(logger_cls, path):
    log = logger_cls(path, also_tensorboard=False)
    for i in range(5):
        log.add_scalar("train/loss", 1.0 / (i + 1), i)
    log.add_scalars({"dev/acc": 0.9, "dev/eer": 0.1}, 4)
    log.close()


def test_metrics_logger_round_trip_matches_adfmsl(tmp_path):
    from adfmsl.utils import MetricsLogger as JaxMetricsLogger
    from adfmsl.utils import read_metrics as jax_read_metrics

    _log_sequence(MetricsLogger, str(tmp_path / "port"))
    _log_sequence(JaxMetricsLogger, str(tmp_path / "adfmsl"))
    back = read_metrics(str(tmp_path / "port"))
    assert len(back["train/loss"]) == 5 and back["train/loss"][0] == (0, 1.0)
    assert back["dev/acc"] == [(4, 0.9)]
    assert back == jax_read_metrics(str(tmp_path / "adfmsl"))
    # both read each other's files, skip a torn last line, and see no file as empty
    with open(tmp_path / "port" / "metrics.jsonl", "a") as fh:
        fh.write('{"step": 5, "tag": "tr')
    assert read_metrics(str(tmp_path / "port")) == back
    assert jax_read_metrics(str(tmp_path / "port")) == back
    assert read_metrics(str(tmp_path / "missing")) == {}
    rec = json.loads((tmp_path / "port" / "metrics.jsonl").read_text().splitlines()[0])
    assert sorted(rec) == ["step", "tag", "value", "wall_time"]


def test_step_timer_matches_adfmsl():
    from adfmsl.utils import StepTimer as JaxStepTimer

    timers = StepTimer(), JaxStepTimer()
    for t in timers:
        for name in ("input", "input", "step"):
            with t.phase(name):
                pass
    s = timers[0].summary()
    assert s["input"]["count"] == 2 and s["step"]["count"] == 1
    assert "input" in timers[0].report()
    assert ({k: v["count"] for k, v in s.items()}
            == {k: v["count"] for k, v in timers[1].summary().items()})
    assert timers[0].report().splitlines()[0] == timers[1].report().splitlines()[0]


def test_registry_holds_adfmsl_model_names():
    from adfmsl.models import model_registry as jax_registry
    from adfmsl.utils import Registry as JaxRegistry
    from adfmsl_torch.models import model_registry

    assert model_registry.names() == jax_registry.names() == list(model_registry)
    for cls in (Registry, JaxRegistry):
        reg = cls("loss")
        reg.register("ce")(len)
        assert "ce" in reg and reg.get("ce") is len
        with pytest.raises(KeyError, match="already has 'ce'"):
            reg.register("ce", len)
        with pytest.raises(KeyError, match="unknown loss 'focal'; known: ce"):
            reg.get("focal")


def test_set_global_seed_matches_adfmsl():
    from adfmsl.utils import set_global_seed as jax_set_global_seed

    gen = set_global_seed(123)
    ours = (np.random.random(3), random.random())
    jax_set_global_seed(123)
    assert np.array_equal(ours[0], np.random.random(3)) and ours[1] == random.random()
    assert torch.equal(torch.rand(2, generator=gen),
                       torch.rand(2, generator=torch.Generator().manual_seed(123)))


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with trace(str(tmp_path / "prof")):
        with annotate("port.region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "port.region" for e in events)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("utils_cli")
    return generate_fixture(str(root / "fixture"), SyntheticSpec(n_train=12, n_dev=8,
                                                                 n_eval=8))


def _small_yaml(path, **extra):
    from adfmsl_torch.config import make_experiment, save_yaml

    exp = make_experiment("maze5")
    exp.data.cut, exp.data.prefetch = CUT, 0
    exp.train.batch_size, exp.train.num_epochs, exp.train.log_every_steps = BATCH, 1, 0
    exp.model.extra.update(extra)
    save_yaml(exp, path)
    return path


def test_cli_train_config_log_dir_profile_dir(fixture, tmp_path, monkeypatch, caplog):
    import logging
    import sys

    # another test file's tensorboardX stub (no close()) may sit in sys.modules
    # on this worker: let MetricsLogger import the package afresh
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)

    import adfmsl_torch.config as config
    from adfmsl.config import load_yaml as jax_load_yaml
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.config import load_yaml
    from adfmsl_torch.models import load_checkpoint
    from adfmsl_torch.train import CheckpointManager
    from adfmsl_torch.train.steps import STEP_LABELS

    ck, logs, prof = (str(tmp_path / d) for d in ("ck", "logs", "prof"))
    cfg = _small_yaml(str(tmp_path / "maze5_small.yaml"))
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]
    caplog.set_level(logging.INFO)
    argv = ["--config", cfg, "--train_protocol", tr["protocol"], "--train_dir",
            tr["audio_dir"], "--dev_protocol", dv["protocol"], "--dev_dir", dv["audio_dir"],
            "--checkpoint_dir", ck, "--device", "cpu"]
    assert cli_train.main(argv + ["--log_dir", logs, "--profile_dir", prof]) == 0

    met = CheckpointManager(ck).metrics(0)
    got = read_metrics(logs)
    assert got == {"train/loss": [(0, met["train_loss"])],
                   "train/acc": [(0, met["train_acc"])], "dev/acc": [(0, met["dev_acc"])]}
    assert all(np.isfinite(v) for (_, v), in got.values())

    used, _ = load_checkpoint(ck)             # model.pt: the tree the run used
    assert used.data.cut == CUT and used.data.database_path == "data/"
    tree = dataclasses.asdict(used)
    yaml_path = os.path.join(ck, "experiment.yaml")
    assert dataclasses.asdict(jax_load_yaml(yaml_path)) == tree
    assert dataclasses.asdict(load_yaml(yaml_path)) == tree

    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert set(STEP_LABELS) <= names
    report = next(r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("step timing"))
    rows = {ln.split()[0]: int(ln.split()[2]) for ln in report.splitlines()[2:]}
    assert rows == {"input": 3 + 1, "train_step": 3}    # the last wait finds the end

    # an --eval run from a changed YAML leaves the training config as it was
    with open(yaml_path) as fh:
        before = fh.read()
    fused = _small_yaml(str(tmp_path / "maze5_fused.yaml"), fused_eval_trunk=True)
    assert cli_train.main(argv[:1] + [fused] + argv[2:] + [
        "--eval", "--restore", "--eval_protocol", ev["protocol"], "--eval_dir",
        ev["audio_dir"], "--eval_output", str(tmp_path / "eval_scores.txt")]) == 0
    with open(yaml_path) as fh:
        assert fh.read() == before

    # cli.evaluate takes the config from experiment.yaml, else from model.pt
    read = []
    monkeypatch.setattr(config, "load_yaml", lambda p: read.append(p) or load_yaml(p))
    outs = {}
    for label in ("yaml", "model_pt"):
        if label == "model_pt":
            os.remove(yaml_path)
        outs[label] = str(tmp_path / f"{label}_scores.txt")
        assert evaluate.main(["--model_type", "maze5", "--model_path", ck, "--protocol",
                              ev["protocol"], "--data_dir", ev["audio_dir"], "--output",
                              outs[label], "--batch_size", "4", "--device", "cpu"]) == 0
    assert read == [yaml_path]
    with open(outs["yaml"]) as a, open(outs["model_pt"]) as b:
        lines = a.read()
        assert lines == b.read()
    assert [ln.split()[0] for ln in lines.splitlines()] == ev["utt_ids"]


def test_cli_evaluate_profile_dir_writes_the_port_spans(fixture, tmp_path):
    from adfmsl_torch.cli import evaluate

    ev, prof = fixture["eval"], str(tmp_path / "prof")
    out = str(tmp_path / "scores.txt")
    assert evaluate.main(["--model_type", "maze5", "--protocol", ev["protocol"], "--data_dir",
                          ev["audio_dir"], "--output", out, "--cut", str(CUT), "--batch_size",
                          "4", "--device", "cpu", "--profile_dir", prof]) == 0
    with open(out) as fh:
        assert [ln.split()[0] for ln in fh] == ev["utt_ids"]
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    batches = len(ev["utt_ids"]) // 4
    assert {n: names.count(n) for n in ("stage.runner.drain", "stage.loader.get",
                                        "stage.model.frontend", "stage.model.trunk",
                                        "stage.model.head", "stage.k1.weights")} == {
        "stage.runner.drain": 1, "stage.loader.get": batches, "stage.model.frontend": batches,
        "stage.model.trunk": batches, "stage.model.head": batches,
        "stage.k1.weights": 5 * batches}
