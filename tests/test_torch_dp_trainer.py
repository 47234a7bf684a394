"""Data-parallel training of the port: ``Trainer(mesh=...)`` against adfmsl's
``Trainer(mesh=...)`` (``adfmsl/train/loop.py`` :111-123, :208-228), its two
``fit`` guards, and ``cli.train --data_parallel``.

- maze5 at f32, cut 4000, the randomness off, a global batch of 8 (4 rows a
  rank), two epochs over the fixture's 24 train utterances, dev batches of 5
  (padded to 6 on the ranks), both from adfmsl's initial weights; adfmsl on a
  2-device mesh of the 8 virtual CPU devices, the port on 2 spawned gloo
  ranks (CPU, one thread each, 300 s limit): each epoch's train loss within 2e-3
  relative, dev accuracy and EER within 1e-6 (``tests/test_parallel.py``'s
  bounds); the ranks end with equal parameters; rank 0 wrote the checkpoints.
- ``fit`` refuses a batch that does not divide the data ranks and a train
  loader that keeps its last partial batch, as adfmsl's does.
- ``python -m adfmsl_torch.cli.train --data_parallel 2 --dist_backend gloo
  --dist_timeout 300 --device cpu`` (lcnn1d_lfcc at the configuration's full
  cut, batch 4, one epoch with a dev set, the configuration's dropout and
  SpecAugment on, so each rank draws its own masks): a checkpoint with finite metrics, no
  skipped step, the two steps' updates applied, and each rank's summary line.
"""
import json
import os

import numpy as np
import pytest
import torch

from adfmsl_torch.data import SyntheticSpec, generate_fixture
from adfmsl_torch.parallel import launch
import torch_rank_workers as W

CUT, BATCH = 4000, 8


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(fn, *args):
    return launch(fn, 2, args, backend="gloo", device="cpu", timeout=W.LIMIT)


def test_trainer_mesh_fit_matches_adfmsl_mesh_fit(fixture_dir, tmp_path):
    import jax

    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.data import parse_protocol as jax_parse
    from adfmsl.parallel import make_mesh
    from adfmsl.train import Trainer as JaxTrainer
    from adfmsl.train import make_dataset_and_loader as jax_loader

    from adfmsl_torch.models import state_dict_from_flax

    exp = W.deterministic(jax_experiment("maze5"), cut=CUT)
    exp.train.batch_size, exp.train.num_epochs = BATCH, 2
    exp.data.prefetch = 0
    tr, dv = fixture_dir["train"], fixture_dir["dev"]
    loader = jax_loader(exp, jax_parse(tr["protocol"]), tr["audio_dir"], shuffle=True)
    dev = jax_loader(exp, jax_parse(dv["protocol"]), dv["audio_dir"], shuffle=False,
                     batch_size=5, drop_last=False)
    jt = JaxTrainer(exp, loader, dev, mesh=make_mesh(JaxMeshConfig(),
                                                     devices=jax.devices()[:2]))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jt.state.params),
                              jax.tree.map(np.asarray, jt.state.batch_stats), "maze5")
    ref = jt.fit()
    ck = str(tmp_path / "ck")
    out = _run(W.dp_fit, "maze5", fixture_dir, CUT, BATCH, 2, ck, sd)
    assert out[0]["history"] == out[1]["history"]
    for (loss, _, acc, eer), r in zip(out[0]["history"], ref):
        assert loss == pytest.approx(r.train_loss, rel=2e-3)
        assert acc == pytest.approx(r.dev_acc, abs=1e-6)
        assert eer == pytest.approx(r.dev_eer, abs=1e-6)
    assert len(out[0]["history"]) == len(ref) == 2
    kept = [d for d in os.listdir(ck) if d.startswith("epoch_")]
    assert kept and all(os.path.exists(os.path.join(ck, d, "model.pt")) for d in kept)


def test_fit_refuses_what_would_pad_the_train_batches(fixture_dir, tmp_path):
    odd = _run(W.dp_fit, "lcnn1d_lfcc", fixture_dir, CUT, 5, 1, None)
    assert all("must be divisible by the data-parallel axis size 2" in o["error"]
               for o in odd)
    keep = _run(W.dp_fit, "lcnn1d_lfcc", fixture_dir, CUT, 4, 1, None, None, False)
    assert all("drop_last=True" in o["error"] for o in keep)


def test_cli_train_data_parallel_one_epoch(tmp_path, capfd):
    from adfmsl_torch.cli import train as cli_train

    fx = generate_fixture(str(tmp_path / "fx"), SyntheticSpec(n_train=8, n_dev=4, n_eval=2))
    ck = str(tmp_path / "ck")
    rc = cli_train.main(["--model", "lcnn1d_lfcc", "--train_protocol", fx["train"]["protocol"],
                         "--train_dir", fx["train"]["audio_dir"], "--dev_protocol",
                         fx["dev"]["protocol"], "--dev_dir", fx["dev"]["audio_dir"],
                         "--batch_size", "4", "--num_epochs", "1", "--checkpoint_dir", ck,
                         "--device", "cpu", "--data_parallel", "2", "--dist_backend", "gloo",
                         "--dist_timeout", str(W.LIMIT)])
    assert rc == 0
    with open(os.path.join(ck, "epoch_0", "metrics.json")) as fh:
        metrics = json.load(fh)
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["skipped"] == 0
    ts = torch.load(os.path.join(ck, "epoch_0", "train_state.pt"), weights_only=True)
    assert ts["step"] == 2 and ts["optimizer"]["count"] == 2
    summaries = [json.loads(ln.split(" ", 1)[1]) for ln in capfd.readouterr().out.splitlines()
                 if ln.startswith("rank_summary ")]
    assert sorted(s["rank"] for s in summaries) == [0, 1]
