"""The port's few-shot slice as a whole: ``FewshotTrainer``, its warm start
through ``CheckpointManager.restore_params``, ``python -m
adfmsl_torch.cli.fewshot`` and the 'wild' fixture, against adfmsl.

- ``FewshotTrainer`` on maze5 at full width, cut 8000, f32 with the
  randomness off (dropout, SpecAugment): 2-way 2-shot episodes with 2
  queries, 2 episodes a step, 3 meta steps, both sides from adfmsl's initial
  weights (carried across by ``state_dict_from_flax``) and the same episodes
  (the same numpy generator). Each step's loss, then the prototypes adapted
  from 2 support utterances a class of the eval split and every held-out
  score, within 1e-3 absolute of adfmsl's. The steps compound Adam updates
  whose noise-level coordinates flip (about lr * sign(g) each): step 0 agreed
  to 3e-7, step 2 to 6e-5 (4e-4 relative), the scores to 4e-5.
- A warm start from a checkpoint: the parameters and BN statistics of the
  best retained epoch, not of the random init, and no optimizer state;
  an empty directory raises ``FileNotFoundError``.
- The CLI with ``--device cpu``: a score file with every utterance of the
  adapt protocol but the K support utterances of each class, in "utt score"
  lines, and the printed metrics; without a card and without ``--device
  cpu`` it raises.
- ``generate_wild_fixture``: the protocol and every WAV byte equal adfmsl's.
- ``mesh=`` (ROADMAP slice 8) trains the episode axis data-parallel over two
  ranks as adfmsl's mesh does.
"""
import ast
import filecmp
import os

import numpy as np
import pytest
import torch

import jax

from adfmsl_torch.config import make_experiment
from adfmsl_torch.data import (AsvspoofDataset, SyntheticSpec, generate_wild_fixture,
                               parse_protocol)
from adfmsl_torch.models import state_dict_from_flax
from adfmsl_torch.train import (CheckpointManager, FewshotConfig, FewshotTrainer,
                                Optimizer, TrainState)
from test_torch_train_step import deterministic

CUT = 8000
FCFG = dict(n_way=2, k_shot=2, q_queries=2, episodes_per_batch=2, n_steps=3, lr=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _exp():
    exp = deterministic(make_experiment("maze5"), "float32")
    exp.data.cut = CUT
    return exp


def _support(ds, proto, k):
    xs, ys = [], []
    for cls in (0, 1):
        for u in [u for u in proto.utt_ids if proto.labels[u] == cls][:k]:
            xs.append(ds.load(u)[0])
            ys.append(cls)
    return np.stack(xs), np.asarray(ys)


def test_trainer_losses_and_adapted_scores_match_adfmsl(fixture_dir):
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.data import AsvspoofDataset as JaxDataset
    from adfmsl.data import parse_protocol as jax_parse_protocol
    from adfmsl.train import FewshotConfig as JaxFewshotConfig
    from adfmsl.train import FewshotTrainer as JaxFewshotTrainer

    tr, ev = fixture_dir["train"], fixture_dir["eval"]
    jexp = deterministic(jax_experiment("maze5"), "float32")
    jexp.data.cut = CUT
    jproto = jax_parse_protocol(tr["protocol"])
    jtrainer = JaxFewshotTrainer(jexp, JaxFewshotConfig(**FCFG), jproto,
                                 JaxDataset(jproto, tr["audio_dir"], cut=CUT))
    params = jax.tree.map(np.asarray, jtrainer.params)
    stats = jax.tree.map(np.asarray, jtrainer.batch_stats)
    jhist = jtrainer.fit()

    proto = parse_protocol(tr["protocol"])
    trainer = FewshotTrainer(_exp(), FewshotConfig(**FCFG), proto,
                             AsvspoofDataset(proto, tr["audio_dir"], cut=CUT), device="cpu")
    trainer.model.load_state_dict(state_dict_from_flax(params, stats, "maze5"), strict=True)
    hist = trainer.fit()
    assert [h["step"] for h in hist] == [0, 1, 2]
    for h, j in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=0, atol=1e-3,
                                   err_msg=f"step {h['step']}")
        print(f"step {h['step']}: loss {h['loss']:.7f}, adfmsl {j['loss']:.7f}")
        assert h["acc"] == j["acc"]

    eproto, jeproto = parse_protocol(ev["protocol"]), jax_parse_protocol(ev["protocol"])
    eds = AsvspoofDataset(eproto, ev["audio_dir"], cut=CUT)
    jeds = JaxDataset(jeproto, ev["audio_dir"], cut=CUT)
    sx, sy = _support(eds, eproto, 2)
    protos = trainer.adapt(sx, sy)
    jprotos = jtrainer.adapt(sx, sy)
    np.testing.assert_allclose(protos.numpy(), np.asarray(jprotos), rtol=0, atol=1e-3)
    scores = trainer.score_protocol(eds, protos, batch_size=8)
    jscores = jtrainer.score_protocol(jeds, jprotos, batch_size=8)
    assert list(scores) == list(jscores) == eproto.utt_ids
    got, ref = np.asarray(list(scores.values())), np.asarray(list(jscores.values()))
    assert np.isfinite(got).all()
    print(f"held-out scores: max |diff| {np.abs(got - ref).max():.3g}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    # 16 utterances at batch 5: the last chunk is padded with silence, and
    # every row scores as it does unpadded
    padded = trainer.score_protocol(eds, protos, batch_size=5)
    np.testing.assert_allclose(np.asarray(list(padded.values())), got, rtol=0, atol=1e-5)


def test_warm_start_restores_the_best_epoch(fixture_dir, tmp_path):
    """Two retained epochs with dev accuracy 0.5 then 0.25: the warm start
    takes epoch 0's parameters and BN statistics, and meta-training goes on."""
    from adfmsl_torch.models import build_model

    tr = fixture_dir["train"]
    proto = parse_protocol(tr["protocol"])
    ds = AsvspoofDataset(proto, tr["audio_dir"], cut=CUT)
    exp = _exp()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep_best_k=2)
    saved = {}
    for epoch, acc in ((0, 0.5), (1, 0.25)):
        model = build_model(exp.model, device="cpu", seed=10 + epoch)
        for b in model.buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5)
        ckpt.save(epoch, exp, TrainState(model, Optimizer.for_model(exp, model, 1), 0),
                  {"dev_acc": acc})
        saved[epoch] = {k: v.clone() for k, v in model.state_dict().items()}
    few = FewshotTrainer(exp, FewshotConfig(**{**FCFG, "n_steps": 1}), proto, ds,
                         checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    assert few.start_epoch == 0
    for k, v in few.model.state_dict().items():
        assert torch.equal(v, saved[0][k]), k
    assert few.optimizer.count == 0 and not few.optimizer.opt.state
    few.fit()
    assert np.isfinite(few.history[-1]["loss"]) and few.optimizer.count == 1
    assert ckpt.restore_params(build_model(exp.model, device="cpu"), epoch=1) == 1
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore_params(
            build_model(exp.model, device="cpu"))


def test_cli_writes_held_out_scores(fixture_dir, tmp_path, capsys):
    from adfmsl_torch.cli import fewshot

    tr, ev = fixture_dir["train"], fixture_dir["eval"]
    out = tmp_path / "fs_scores.txt"
    rc = fewshot.main(["--model", "maze5", "--train_protocol", tr["protocol"],
                       "--train_dir", tr["audio_dir"], "--adapt_protocol", ev["protocol"],
                       "--adapt_dir", ev["audio_dir"], "--k_shot", "2", "--q_queries", "2",
                       "--episodes_per_batch", "2", "--n_steps", "2", "--cut", "4000",
                       "--output", str(out), "--device", "cpu"])
    assert rc == 0
    proto = parse_protocol(ev["protocol"])
    lines = [ln.split() for ln in out.read_text().strip().splitlines()]
    assert len(lines) == len(proto.utt_ids) - 4
    ids = [ln[0] for ln in lines]
    assert set(ids) < set(proto.utt_ids) and ids == [u for u in proto.utt_ids if u in ids]
    assert np.isfinite([float(ln[1]) for ln in lines]).all()
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["n_support_excluded"] == 4 and 0.0 <= printed["eer"] <= 1.0


def test_cli_needs_a_card_unless_told_cpu(fixture_dir, tmp_path, monkeypatch):
    from adfmsl_torch.cli import fewshot

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr, ev = fixture_dir["train"], fixture_dir["eval"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fewshot.main(["--train_protocol", tr["protocol"], "--train_dir", tr["audio_dir"],
                      "--adapt_protocol", ev["protocol"], "--adapt_dir", ev["audio_dir"],
                      "--n_steps", "1", "--output", str(tmp_path / "s.txt")])
    assert fewshot.build_parser().parse_args(
        ["--train_protocol", "a", "--train_dir", "b", "--adapt_protocol", "c",
         "--adapt_dir", "d"]).device == "cuda"


@pytest.mark.parametrize("n_eval,seed", [(12, 0), (32, 11)])
def test_wild_fixture_matches_adfmsl(tmp_path, n_eval, seed):
    from adfmsl.data import SyntheticSpec as JaxSpec
    from adfmsl.data import generate_wild_fixture as jax_wild

    got = generate_wild_fixture(str(tmp_path / "port"), SyntheticSpec(n_eval=n_eval, seed=seed))
    ref = jax_wild(str(tmp_path / "jax"), JaxSpec(n_eval=n_eval, seed=seed))
    assert got["eval"]["utt_ids"] == ref["eval"]["utt_ids"]
    with open(got["eval"]["protocol"], "rb") as a, open(ref["eval"]["protocol"], "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(ref["eval"]["audio_dir"]))
    assert names == sorted(os.listdir(got["eval"]["audio_dir"])) and len(names) == n_eval
    match, mismatch, errors = filecmp.cmpfiles(ref["eval"]["audio_dir"],
                                               got["eval"]["audio_dir"], names, shallow=False)
    assert match == names and not mismatch and not errors
    labels = parse_protocol(got["eval"]["protocol"]).labels
    assert sorted(set(labels.values())) == [0, 1]


def test_mesh_names_slice_8(fixture_dir):
    """ROADMAP slice 8's mesh: ``FewshotTrainer(mesh=...)`` on 2 spawned gloo
    ranks (one episode each; CPU, 300 s limit) against adfmsl's
    ``FewshotTrainer(mesh=...)`` on a 2-device mesh, from the same weights:
    each meta step's loss within 1e-3 and its accuracy equal, as one process
    is held above; the ranks end with equal parameters."""
    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.data import AsvspoofDataset as JaxDataset
    from adfmsl.data import parse_protocol as jax_parse_protocol
    from adfmsl.parallel import make_mesh
    from adfmsl.train import FewshotConfig as JaxFewshotConfig
    from adfmsl.train import FewshotTrainer as JaxFewshotTrainer

    from adfmsl_torch.parallel import launch
    import torch_rank_workers as W

    tr = fixture_dir["train"]
    jexp = deterministic(jax_experiment("maze5"), "float32")
    jexp.data.cut = CUT
    jproto = jax_parse_protocol(tr["protocol"])
    jtrainer = JaxFewshotTrainer(jexp, JaxFewshotConfig(**FCFG), jproto,
                                 JaxDataset(jproto, tr["audio_dir"], cut=CUT),
                                 mesh=make_mesh(JaxMeshConfig(), devices=jax.devices()[:2]))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jtrainer.params),
                              jax.tree.map(np.asarray, jtrainer.batch_stats), "maze5")
    jhist = jtrainer.fit()
    out = launch(W.fewshot_fit, 2, ({"protocol": tr["protocol"],
                                     "audio_dir": tr["audio_dir"]}, sd, FCFG, CUT),
                 backend="gloo", device="cpu", timeout=W.LIMIT)
    assert out[0]["history"] == out[1]["history"]
    assert len(out[0]["history"]) == len(jhist) == FCFG["n_steps"]
    for (loss, acc), j in zip(out[0]["history"], jhist):
        np.testing.assert_allclose(loss, j["loss"], rtol=0, atol=1e-3)
        assert acc == j["acc"]
