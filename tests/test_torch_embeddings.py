"""Embeddings (``evaluation/runner.py:produce_embeddings``, ``collect_features``)
and ``cli.evaluate --dump_embeddings`` of the port against adfmsl's.

The same adfmsl weights (init, then non-trivial BatchNorm statistics as in
tests/test_torch_maze5.py) go through adfmsl's ``produce_embeddings`` and,
by ``state_dict_from_flax``, through the port's, over the same synthetic
fixture (10 eval utterances in batches of 4, so the last batch has padding
rows), for maze5_fmsl, RawNet main and maze7_fmsl (the 'tiny' Wav2Vec2 arch)
at cut 4000 in f32. Tolerances: ids equal; features and scores within
1e-4 * max(1, |ref|), the f32 tolerance of tests/test_torch_maze5.py.
A forced out-of-memory split and the mesh gather keep features and scores
aligned with the ids (equal to the plain run within 1e-5 * max(1, |x|): the
halves are other batch shapes; 1e-6 for the same shapes run again). The CLIs'
``.npz`` files have the same keys and ids, and unit prototype / class-weight
rows within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl.train import make_dataset_and_loader as jax_loader
from adfmsl.train.state import TrainState
from adfmsl_torch.config import make_experiment
from adfmsl_torch.data import SyntheticSpec, generate_fixture, parse_protocol
from adfmsl_torch.models import build_model, state_dict_from_flax
from adfmsl_torch.train import make_dataset_and_loader

CUT, BATCH = 4000, 4
NAMES = ["maze5_fmsl", "main", "maze7_fmsl"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _exp(make, name):
    e = make(name)
    e.data.cut = CUT
    e.model.dtype = "float32"
    e.model.extra["fused_eval_trunk"] = False
    if name.startswith("maze7"):
        e.model.wav2vec2.model_name = "tiny"
    return e


def _close(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("emb")),
                            SyntheticSpec(n_train=2, n_dev=2, n_eval=10))


@pytest.fixture(scope="module")
def reference(fixture):
    """Per model: adfmsl's embeddings and the weights they came from."""
    from adfmsl.data import parse_protocol as jax_protocol
    from adfmsl.evaluation import produce_embeddings as jax_embeddings

    rng = np.random.default_rng(11)
    ev = fixture["eval"]
    out = {}
    for name in NAMES:
        exp = _exp(jax_experiment, name)
        model = jax_build_model(exp.model)
        v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, CUT)))
        params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
        stats = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)
                                              .astype(np.float32) * 0.3) + 0.1,
                             v["batch_stats"])
        if "fmsl" in stats and "proj_bn" in stats["fmsl"]:
            mean = stats["fmsl"]["proj_bn"]["mean"]
            stats["fmsl"]["proj_bn"]["mean"] = rng.standard_normal(mean.shape).astype(
                np.float32) * 0.01
        state = TrainState.create(model.apply, params, stats, optax.identity())
        loader = jax_loader(exp, jax_protocol(ev["protocol"]), ev["audio_dir"],
                            shuffle=False, batch_size=BATCH, drop_last=False)
        out[name] = {"params": params, "stats": stats,
                     "emb": jax_embeddings(state, loader)}
    return out


def _port(name, ref, fixture):
    exp = _exp(make_experiment, name)
    model = build_model(exp.model, device="cpu").eval()
    model.load_state_dict(state_dict_from_flax(ref["params"], ref["stats"], name), strict=True)
    ev = fixture["eval"]
    loader = make_dataset_and_loader(exp, parse_protocol(ev["protocol"]), ev["audio_dir"],
                                     shuffle=False, batch_size=BATCH, drop_last=False)
    return model, loader


@pytest.mark.parametrize("name", NAMES)
def test_embeddings_match_adfmsl(reference, fixture, name):
    from adfmsl_torch.evaluation import EmbeddingResult, produce_embeddings, produce_scores

    ref = reference[name]["emb"]
    model, loader = _port(name, reference[name], fixture)
    got = produce_embeddings(model, loader)
    assert isinstance(got, EmbeddingResult)
    assert got.utt_ids == ref.utt_ids == fixture["eval"]["utt_ids"]
    assert got.features.dtype == np.float32 and got.features.shape == ref.features.shape
    assert got.features.shape[0] == 10 and np.abs(ref.features).max() > 0
    _close(got.features, ref.features, 1e-4)
    _close(got.scores, ref.scores, 1e-4)
    plain = produce_scores(model, loader)
    assert plain.features is None and plain.utt_ids == got.utt_ids
    _close(plain.scores, got.scores, 1e-6)


def test_oom_split_and_mesh_gather_keep_rows_aligned(reference, fixture, monkeypatch):
    """The first forward raises ``torch.OutOfMemoryError``: that batch is
    scored in halves, whose features and scores meet again in row order.
    Under a (one-rank) mesh the features go through ``gather_rows``."""
    from types import SimpleNamespace

    from adfmsl_torch.evaluation import produce_embeddings, runner

    model, loader = _port("maze5_fmsl", reference["maze5_fmsl"], fixture)
    plain = produce_embeddings(model, loader)
    forward, calls = model.forward, []

    def flaky(x, *a, **k):
        calls.append(len(x))
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return forward(x, *a, **k)

    monkeypatch.setattr(model, "forward", flaky)
    split = produce_embeddings(model, loader)
    assert calls[:3] == [BATCH, BATCH // 2, BATCH // 2]
    assert split.utt_ids == plain.utt_ids
    _close(split.features, plain.features, 1e-5)
    _close(split.scores, plain.scores, 1e-5)
    monkeypatch.setattr(model, "forward", forward)

    reduced = []
    monkeypatch.setattr(runner.dist, "all_reduce",
                        lambda buf, group=None: reduced.append(tuple(buf.shape)))
    mesh = SimpleNamespace(rank=0, data_rank=0, dp=1, data_group=None)
    meshed = produce_embeddings(model, loader, mesh=mesh)
    assert reduced == [(12,), (12, plain.features.shape[1])]     # scores, then features
    assert meshed.utt_ids == plain.utt_ids
    _close(meshed.features, plain.features, 1e-6)
    _close(meshed.scores, plain.scores, 1e-6)


def test_dump_embeddings_cli_matches_adfmsl(fixture, tmp_path):
    from adfmsl.cli.evaluate import main as jax_eval
    from adfmsl_torch.cli.evaluate import main as port_eval

    ev = fixture["eval"]
    common = ["--model_type", "maze5_fmsl", "--cut", str(CUT), "--protocol", ev["protocol"],
              "--data_dir", ev["audio_dir"], "--batch_size", "6", "--no_fused_trunk"]
    files = {}
    for tag, main, extra in (("jax", jax_eval, []), ("port", port_eval, ["--device", "cpu"])):
        files[tag] = str(tmp_path / f"{tag}.npz")
        assert main(common + extra + ["--output", str(tmp_path / f"{tag}_scores.txt"),
                                      "--dump_embeddings", files[tag]]) == 0
    with np.load(files["jax"]) as a, np.load(files["port"]) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            ["utt_ids", "features", "scores", "prototypes", "class_weights"])
        assert list(a["utt_ids"]) == list(b["utt_ids"]) == ev["utt_ids"]
        assert b["features"].shape == (10, 1024) and np.isfinite(b["features"]).all()
        for z in (a, b):
            for key in ("prototypes", "class_weights"):
                np.testing.assert_allclose(np.linalg.norm(z[key], axis=-1), 1.0,
                                           rtol=0, atol=1e-6)
        assert b["prototypes"].shape == a["prototypes"].shape == (3, 1024)
