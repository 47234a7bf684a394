"""The slice as a whole: ``python -m adfmsl_torch.cli.train`` against adfmsl's
``Trainer`` on the synthetic ASVspoof fixture.

maze5 at f32, full width, cut 4000, batch 4, two epochs (3 steps each), the
randomness off (dropout rates 0, SpecAugment off), both from adfmsl's
initial weights (the port's ``build_model`` is patched to load them through
``state_dict_from_flax``). The CLI runs in-process.

Tolerances: each epoch's mean train loss within 1e-4 relative of adfmsl's
(the steps compound AdamW updates whose noise-level coordinates flip, see
test_torch_train_step.py); dev accuracy equal (8 utterances). Then: the
checkpoints that best-k retention keeps are those adfmsl's Orbax manager
keeps; ``--restore`` continues after the latest retained epoch; and
``cli.evaluate --model_path`` reads the result and writes a score file.
"""
import os

import numpy as np
import pytest
import torch

import jax

from adfmsl_torch.data import SyntheticSpec, generate_fixture

CUT, BATCH = 4000, 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(exp):
    exp.data.cut = CUT
    exp.data.prefetch = 0
    exp.model.dtype = "float32"
    exp.model.architecture.dropout_rate = 0.0
    exp.model.architecture.fc_dropout = 0.0
    exp.model.spec_augment.enabled = False
    exp.train.batch_size = BATCH
    exp.train.num_epochs = 2
    exp.train.log_every_steps = 0
    return exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """adfmsl's Trainer and the port's CLI on the same fixture; returns both
    histories and directories."""
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.data import parse_protocol as jax_parse_protocol
    from adfmsl.train import Trainer as JaxTrainer
    from adfmsl.train import make_dataset_and_loader as jax_loader

    root = tmp_path_factory.mktemp("trainer")
    info = generate_fixture(str(root / "fixture"), SyntheticSpec(n_train=12, n_dev=8,
                                                                 n_eval=8))
    exp = _setup(jax_experiment("maze5"))
    exp.data.use_native_io = False
    train = jax_loader(exp, jax_parse_protocol(info["train"]["protocol"]),
                       info["train"]["audio_dir"], shuffle=True)
    dev = jax_loader(exp, jax_parse_protocol(info["dev"]["protocol"]),
                     info["dev"]["audio_dir"], shuffle=False,
                     batch_size=exp.train.eval_batch_size, drop_last=False)
    jt = JaxTrainer(exp, train, dev, checkpoint_dir=str(root / "jax_ck"))
    init = jax.tree.map(lambda a: np.array(a, np.float32),
                        (jt.state.params, jt.state.batch_stats))
    history = jt.fit()
    return {"info": info, "root": root, "jax": history, "init": init,
            "jax_epochs": jt.ckpt.all_epochs()}


def _run_cli(monkeypatch, runs, ck, extra):
    """cli.train on the port, at the test's settings and from adfmsl's init;
    returns the (epoch, train loss, dev accuracy) of each epoch it trained."""
    import adfmsl_torch.config as config
    import adfmsl_torch.train as train_pkg
    import adfmsl_torch.train.loop as loop
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.models import state_dict_from_flax

    make = config.make_experiment
    monkeypatch.setattr(config, "make_experiment", lambda *a, **k: _setup(make(*a, **k)))
    build = loop.build_model

    def build_from_adfmsl(cfg, device=None, seed=0):
        model = build(cfg, device=device, seed=seed)
        model.load_state_dict(state_dict_from_flax(*runs["init"], cfg.name), strict=True)
        return model
    monkeypatch.setattr(loop, "build_model", build_from_adfmsl)
    histories = []

    class Recording(train_pkg.Trainer):
        def fit(self, num_epochs=None):
            histories.append(super().fit(num_epochs))
            return histories[-1]
    monkeypatch.setattr(train_pkg, "Trainer", Recording)
    info = runs["info"]
    argv = ["--model", "maze5", "--train_protocol", info["train"]["protocol"],
            "--train_dir", info["train"]["audio_dir"],
            "--dev_protocol", info["dev"]["protocol"], "--dev_dir", info["dev"]["audio_dir"],
            "--checkpoint_dir", ck, "--device", "cpu", *extra]
    assert cli_train.main(argv) == 0
    return [(m.epoch, m.train_loss, m.dev_acc) for m in histories[-1]]


def test_cli_train_matches_adfmsl_trainer(runs, monkeypatch, tmp_path):
    from adfmsl_torch.train import CheckpointManager

    got = _run_cli(monkeypatch, runs, str(tmp_path / "ck"), ["--num_epochs", "2"])
    ref = runs["jax"]
    assert [e for e, _, _ in got] == [m.epoch for m in ref] == [0, 1]
    for (epoch, loss, dev_acc), m in zip(got, ref):
        np.testing.assert_allclose(loss, m.train_loss, rtol=1e-4, err_msg=f"epoch {epoch}")
        assert dev_acc == pytest.approx(m.dev_acc, abs=1e-6)
    assert CheckpointManager(str(tmp_path / "ck")).all_epochs() == runs["jax_epochs"]


def test_restore_continues_and_evaluate_reads_the_checkpoint(runs, monkeypatch, tmp_path):
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.train import CheckpointManager

    ck = str(tmp_path / "ck")
    first = _run_cli(monkeypatch, runs, ck, ["--num_epochs", "1"])
    assert [e for e, _, _ in first] == [0]
    again = _run_cli(monkeypatch, runs, ck, ["--num_epochs", "2", "--restore"])
    assert [e for e, _, _ in again] == [1]               # epoch 0 is not trained again
    mgr = CheckpointManager(ck)
    latest = mgr.all_epochs()[-1]
    assert latest == 1 or mgr.all_epochs() == [0]
    ts = torch.load(os.path.join(ck, f"epoch_{latest}", "train_state.pt"), weights_only=True)
    assert ts["step"] == 3 * (latest + 1) and ts["optimizer"]["count"] == 3 * (latest + 1)

    info = runs["info"]
    out = str(tmp_path / "scores.txt")
    rc = evaluate.main(["--model_type", "maze5", "--model_path", ck,
                        "--protocol", info["eval"]["protocol"],
                        "--data_dir", info["eval"]["audio_dir"], "--output", out,
                        "--cut", str(CUT), "--batch_size", "4", "--device", "cpu"])
    assert rc == 0
    with open(out) as fh:
        lines = [ln.split() for ln in fh.read().splitlines()]
    assert [ln[0] for ln in lines] == info["eval"]["utt_ids"]
    assert np.isfinite([float(ln[1]) for ln in lines]).all()


@pytest.mark.parametrize("flag,value,slice_", [("--config", "x.yaml", "slice 9"),
                                               ("--data_parallel", "2", "slice 8"),
                                               ("--train_pack", "p", "slice 9"),
                                               ("--log_dir", "d", "slice 9")])
def test_later_flags_name_their_slice(flag, value, slice_, tmp_path, monkeypatch):
    """Every flag here is ported. ``--config`` and ``--log_dir`` came with
    slice 9's item 9a (tests/test_torch_config_io.py trains with them): a
    missing YAML raises ``FileNotFoundError`` naming it, as adfmsl's
    ``load_yaml`` does, and ``--log_dir`` reaches the data stage, which fails
    on the missing default train protocol before anything is written. The
    pack flags came with item 9d (tests/test_torch_pack.py trains from
    packs): as in adfmsl, the train protocol is parsed before the pack is
    opened, so ``--train_pack`` fails on the same missing protocol. Slice
    8's ``--data_parallel`` is ported (tests/test_torch_dp_trainer.py trains
    with it): asked for ``nccl`` ranks on the CPU, it reaches the launcher,
    which refuses and names ``gloo`` instead of switching backends. Each case
    runs in an empty directory and leaves it empty."""
    from adfmsl_torch.cli import train as cli_train

    monkeypatch.chdir(tmp_path)
    argv = ["--model", "maze5", flag, value, "--device", "cpu"]
    if flag == "--data_parallel":
        with pytest.raises(ValueError, match="gloo"):
            cli_train.main(argv + ["--dist_backend", "nccl"])
    elif flag == "--config":
        with pytest.raises(FileNotFoundError, match=value):
            cli_train.main(argv)
    else:
        with pytest.raises(FileNotFoundError, match="ASVspoof2019.LA.cm.train.trn.txt"):
            cli_train.main(argv)
    assert os.listdir(tmp_path) == []


def test_rawnet_training_and_remat_name_their_slice():
    """RawNet models train (their train-mode forward gives finite logits), and
    a ``train.remat`` step (ported in slice 6c) gives a finite loss."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.train import make_train_step

    model = build_model(make_experiment("main").model, device="cpu")
    model.train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32))
    logits = model(x)["logits"]
    assert logits.shape == (2, 2) and logits.requires_grad and torch.isfinite(logits).all()
    exp = make_experiment("maze5")
    exp.data.cut = 4000
    exp.train.remat = True
    from adfmsl_torch.train import Optimizer, TrainState

    model = build_model(exp.model, device="cpu")
    st = TrainState(model, Optimizer.for_model(exp, model, 10), seed=0)
    met = make_train_step(exp)(st, x, torch.tensor([0, 1]), torch.ones(2, dtype=torch.bool),
                               st.generators(0, 0))
    assert float(met["skipped"]) == 0.0 and torch.isfinite(met["loss"])
    assert st.optimizer.count == 1
