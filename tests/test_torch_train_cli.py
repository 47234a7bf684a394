"""Training RawNet main and lcnn1d_lfcc through the port's CLI and Trainer
on the CPU, as tests/test_torch_trainer.py does for maze5.

At cut 4000, batch 4, on the synthetic ASVspoof fixture (12 train, 8 dev and
8 eval utterances): ``cli.train`` for one epoch without a dev set, then
``--restore`` with the dev set for a second; the checkpoints it wrote hold
finite losses, no skipped step, 3 and then 6 steps and updates, and every
parameter and BN statistic moved; ``cli.evaluate --model_path`` then writes a
complete, finite score file. Last, a ``Trainer`` of main built with
``exp.model.extra['fused_train_frontend']`` (no CLI flag sets it, as in
adfmsl) routes every train step's front end through the trainable K3 wrapper
once, and its dev evaluation through the composition.
"""
import os

import numpy as np
import pytest
import torch

from adfmsl_torch.data import SyntheticSpec, generate_fixture

CUT, BATCH = 4000, 4
NAMES = ["main", "lcnn1d_lfcc"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    return generate_fixture(str(root / "fixture"), SyntheticSpec(n_train=12, n_dev=8,
                                                                 n_eval=8))


def _small(exp):
    exp.data.cut = CUT
    exp.data.prefetch = 0
    exp.train.batch_size = BATCH
    exp.train.log_every_steps = 0
    return exp


@pytest.fixture
def small_experiments(monkeypatch):
    import adfmsl_torch.config as config

    make = config.make_experiment
    monkeypatch.setattr(config, "make_experiment", lambda *a, **k: _small(make(*a, **k)))


@pytest.mark.parametrize("name", NAMES)
def test_cli_train_restore_and_evaluate(name, fixture, small_experiments, tmp_path):
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.models import build_model, load_checkpoint
    from adfmsl_torch.train import CheckpointManager
    from adfmsl_torch.train.checkpoint import TRAIN_STATE_FILE

    ck = str(tmp_path / "ck")
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]
    argv = ["--model", name, "--train_protocol", tr["protocol"], "--train_dir",
            tr["audio_dir"], "--checkpoint_dir", ck, "--device", "cpu",
            "--protocols_path", str(tmp_path / "no_protocols")]
    mgr = CheckpointManager(ck)
    states = {}
    for epoch, extra in ((0, ["--num_epochs", "1"]),
                         (1, ["--num_epochs", "2", "--restore", "--dev_protocol",
                              dv["protocol"], "--dev_dir", dv["audio_dir"]])):
        assert cli_train.main(argv + extra) == 0
        met = mgr.metrics(epoch)
        assert np.isfinite(met["train_loss"]) and met["skipped"] == 0, met
        assert np.isfinite(met["dev_acc"]) == (epoch == 1), met
        path = os.path.join(ck, f"epoch_{epoch}")
        ts = torch.load(os.path.join(path, TRAIN_STATE_FILE), weights_only=True)
        assert ts["step"] == ts["optimizer"]["count"] == 3 * (epoch + 1)
        exp, states[epoch] = load_checkpoint(path)
    assert exp.model.name == name and exp.data.cut == CUT
    init = build_model(exp.model, device="cpu", seed=exp.train.seed).state_dict()
    for a, b in ((init, states[0]), (states[0], states[1])):
        still = [k for k, v in b.items()
                 if not k.endswith("num_batches_tracked") and torch.equal(v, a[k])]
        assert not still, still

    out = str(tmp_path / "scores.txt")
    assert evaluate.main(["--model_type", name, "--model_path", ck, "--protocol",
                          ev["protocol"], "--data_dir", ev["audio_dir"], "--output", out,
                          "--batch_size", "4", "--device", "cpu"]) == 0
    with open(out) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()]
    assert [ln[0] for ln in lines] == ev["utt_ids"]
    assert np.isfinite([float(ln[1]) for ln in lines]).all()


def test_trainer_fused_train_frontend(fixture, monkeypatch):
    """With the extra set, every train step of main (batch 4 <= 16) runs its
    front end through ``sinc_abs_pool`` once; eval (the dev set) takes the
    composition, since ``fused_eval_frontend`` is off."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.models import sincnet
    from adfmsl_torch.train import Trainer, make_dataset_and_loader

    calls = []
    real = sincnet.sinc_abs_pool

    def counted(*args):
        calls.append(args[0].shape[0])
        return real(*args)
    monkeypatch.setattr(sincnet, "sinc_abs_pool", counted)
    exp = _small(make_experiment("main"))
    exp.train.num_epochs = 1
    exp.model.extra["fused_train_frontend"] = True
    tr, dv = fixture["train"], fixture["dev"]
    train = make_dataset_and_loader(exp, parse_protocol(tr["protocol"]), tr["audio_dir"],
                                    shuffle=True)
    dev = make_dataset_and_loader(exp, parse_protocol(dv["protocol"]), dv["audio_dir"],
                                  shuffle=False, batch_size=4, drop_last=False)
    trainer = Trainer(exp, train, dev, device="cpu")
    assert trainer.state.model.encoder.sinc.fused_train
    (m,) = trainer.fit()
    assert calls == [BATCH] * 3
    assert np.isfinite(m.train_loss) and m.skipped_batches == 0 and np.isfinite(m.dev_acc)
