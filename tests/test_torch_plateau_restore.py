"""The plateau LR scale across ``--restore``: the port's ``Trainer`` against
adfmsl's.

lcnn1d_lfcc at cut 4000, batch 4, ``scheduler='plateau'``, on a synthetic
fixture of a few utterances (numpy, seed 0), with no dev set (the tracker
watches the train loss, and no eval step is compiled). Both trainers set the
scale to 0.25 before epoch 0, train it (its checkpoint holds 0.25), restore the
latest checkpoint as the train CLIs' ``--restore`` does, and train one more
epoch. A
fresh ``PlateauTracker`` does not change its scale in its first epoch, so
adfmsl writes nothing (``adfmsl/train/loop.py:282-286``) and the restored 0.25
stands; the port must end with the same scale, exactly. The second test holds
the port alone to the same rule through a new ``Trainer``, as the CLI builds.
"""
import pytest
import torch

from adfmsl_torch.data import SyntheticSpec, generate_fixture

CUT, BATCH, SCALE = 4000, 4, 0.25


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_info(tmp_path_factory):
    root = tmp_path_factory.mktemp("plateau")
    return generate_fixture(str(root / "fixture"),
                            SyntheticSpec(n_train=8, n_dev=2, n_eval=2, seed=0))


def _setup(exp):
    exp.data.cut = CUT
    exp.data.prefetch = 0
    exp.train.batch_size = BATCH
    exp.train.num_epochs = 2
    exp.train.log_every_steps = 0
    exp.train.optimizer.scheduler = "plateau"
    return exp


def _port_trainer(info, ck):
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.train import Trainer, make_dataset_and_loader

    exp = _setup(make_experiment("lcnn1d_lfcc"))
    train = make_dataset_and_loader(exp, parse_protocol(info["train"]["protocol"]),
                                    info["train"]["audio_dir"], shuffle=True)
    return Trainer(exp, train, checkpoint_dir=str(ck), device="cpu")


def _jax_scale(info, ck):
    """adfmsl: scale set, epoch 0, restore, epoch 1; the final scale."""
    from adfmsl.config import make_experiment
    from adfmsl.data import parse_protocol
    from adfmsl.train import Trainer, make_dataset_and_loader
    from adfmsl.train.optim import get_plateau_scale, set_plateau_scale

    exp = _setup(make_experiment("lcnn1d_lfcc"))
    exp.data.use_native_io = False
    train = make_dataset_and_loader(exp, parse_protocol(info["train"]["protocol"]),
                                    info["train"]["audio_dir"], shuffle=True)
    jt = Trainer(exp, train, checkpoint_dir=str(ck))
    jt.state = jt.state.replace(opt_state=set_plateau_scale(jt.state.opt_state, SCALE))
    jt.fit(1)
    jt.state, epoch = jt.ckpt.restore(jt.state)      # adfmsl/cli/train.py:155-157
    jt.epochs_run = epoch + 1
    jt.fit(1)
    assert jt.epochs_run == 2
    return get_plateau_scale(jt.state.opt_state)


def test_restored_scale_matches_adfmsl_after_an_epoch(fixture_info, tmp_path):
    pt = _port_trainer(fixture_info, tmp_path / "port_ck")
    pt.state.optimizer.plateau_scale = SCALE
    pt.fit(1)
    assert pt.restore() == 0
    pt.fit(1)
    assert pt.epochs_run == 2
    want = _jax_scale(fixture_info, tmp_path / "jax_ck")
    assert want == SCALE
    assert pt.state.optimizer.plateau_scale == want


def test_restored_scale_survives_an_unchanged_tracker(fixture_info, tmp_path):
    first = _port_trainer(fixture_info, tmp_path / "ck")
    first.state.optimizer.plateau_scale = SCALE
    first.fit(1)
    resumed = _port_trainer(fixture_info, tmp_path / "ck")   # as cli.train --restore
    assert resumed.state.optimizer.plateau_scale == 1.0
    assert resumed.restore() == 0
    assert resumed.state.optimizer.plateau_scale == SCALE
    resumed.fit(1)
    assert resumed.state.optimizer.plateau_scale == SCALE
