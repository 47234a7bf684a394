"""The LFCC / log-mel models end to end: the port's LCNN, LCNN1D and ResNet18
vs adfmsl's on the same weights and inputs, at full width and cut 15840 (100
frames: even, so ResNet18's stride-2 'SAME' padding is asymmetric at every
stage, as at cut 64600's 404 frames), batch 2. Weights go adfmsl init ->
numpy -> state_dict_from_flax -> load_state_dict(strict=True), with centred
BN running stats and the last Dense scaled so the logits are O(1) to O(10).

Tolerances: logits within 1e-4 * max(1, |logits|) at model.dtype='float32'
and within 3e-2 * max(1, |logits|) at the bf16 default (test_pallas.py's). The
f32 comparison pins the DFT tier to 'highest', because adfmsl on the CPU
computes every tier in f32; the bf16 one keeps the default 'high', whose
bf16x3 DFT the port computes as the TPU does (tests/test_torch_lfcc.py holds
the tiers themselves).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl_torch.cli import evaluate
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import (EXTRAS, build_model, load_checkpoint, save_checkpoint,
                                 state_dict_from_flax)
from adfmsl_torch.models.blocks import same_pads
from test_torch_telemetry import check_model_stages

CUT = 15840
NAMES = ["lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PATHS = {"f32": ("float32", "highest"), "bf16": ("bfloat16", "high")}
# the last Dense and its scale, which brings each model's logits to O(1)-O(10)
LAST_DENSE = {"lcnn_lfcc": ("fc2", 2.0), "lcnn1d_lfcc": ("fc2", 1.0),
              "resnet18_logmel": ("fc", 8.0)}


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _centred_stats(rng, batch_stats):
    def draw(path, a):
        if str(getattr(path[-1], "key", path[-1])) == "mean":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _experiment(make, name, path):
    dtype, precision = PATHS[path]
    exp = make(name)
    exp.data.cut = CUT
    exp.model.dtype = dtype
    exp.model.frontend.dsp_precision = precision
    return exp


@pytest.fixture(scope="module")
def variables():
    """Per model: adfmsl variables, the input batch, adfmsl's logits per path."""
    rng = np.random.default_rng(404)
    out = {}
    for name in NAMES:
        x = rng.standard_normal((2, CUT)).astype(np.float32)
        model = jax_build_model(_experiment(jax_experiment, name, "f32").model)
        v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x))
        params = _numpy_tree(v["params"])
        stats = _centred_stats(rng, _numpy_tree(v["batch_stats"]))
        dense, scale = LAST_DENSE[name]
        params[dense]["kernel"] = params[dense]["kernel"] * scale
        logits = {}
        for path in PATHS:
            m = jax_build_model(_experiment(jax_experiment, name, path).model)
            res = jax.jit(lambda v, x: m.apply(v, x, train=False))(
                {"params": params, "batch_stats": stats}, jnp.asarray(x))
            logits[path] = np.asarray(res["logits"], np.float32)
        out[name] = {"x": x, "params": params, "stats": stats, "logits": logits}
    return out


def _port(name, v, path):
    model = build_model(_experiment(make_experiment, name, path).model, device="cpu")
    model.load_state_dict(state_dict_from_flax(v["params"], v["stats"], name),
                          strict=True)
    return model


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_adfmsl(variables, name, path):
    v = variables[name]
    ref = v["logits"][path]
    assert 0.5 < np.abs(ref).max() < 50          # O(1) logits: the check bites
    with torch.inference_mode():
        out = _port(name, v, path)(torch.from_numpy(v["x"]))
    assert out["logits"].dtype == torch.float32 and out["scores"].shape == (2,)
    torch.testing.assert_close(out["scores"], torch.log_softmax(out["logits"], -1)[:, 1])
    rel = 1e-4 if path == "f32" else 3e-2
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", NAMES)
def test_forward_is_classify_of_features_and_training_raises(variables, name):
    model = _port(name, variables[name], "bf16")
    x = torch.from_numpy(variables[name]["x"])
    with torch.inference_mode():
        feats = model.features(x)
        n = 60 if name.startswith("lcnn") else 80
        assert tuple(feats.shape) == (2, 1 + CUT // 160, n)
        assert torch.equal(model.classify(feats)["logits"], model(x)["logits"])
    model.train()
    out = model(x, rngs={"dropout": torch.Generator().manual_seed(0)})
    assert out["logits"].shape == (2, 2) and torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("name", NAMES)
def test_forward_enters_the_model_stage_spans_in_order(name):
    """The LFCC / log-mel front end with CMVN, the trunk to the pooled
    features and the head are one span each."""
    model = build_model(_experiment(make_experiment, name, "bf16").model, device="cpu")
    check_model_stages(model, torch.zeros((1, CUT)))


def test_extras_are_built_on_the_card_by_default(monkeypatch):
    for name in NAMES:
        assert name in EXTRAS
        m = build_model(make_experiment(name).model, device="cpu", seed=1)
        assert isinstance(m, EXTRAS[name]) and not m.training
    exp = make_experiment("maze2")
    exp.model.wav2vec2.model_name = "tiny"
    exp.model.wav2vec2.remat_layers = True          # ported in slice 6c
    m = build_model(exp.model, device="cpu")
    assert m.wav2vec2.remat_layers and not m.wav2vec2.remat_extractor
    m.train()
    out = m(torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4000))
                             .astype(np.float32)),
            rngs={k: torch.Generator().manual_seed(i)
                  for i, k in enumerate(("dropout", "specaugment"))})
    assert out["logits"].shape == (2, 2) and torch.isfinite(out["logits"]).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(make_experiment("lcnn1d_lfcc").model)


@pytest.mark.parametrize("size,k,stride,want", [(404, 7, 2, (2, 3)), (80, 7, 2, (2, 3)),
                                                (202, 3, 2, (0, 1)), (101, 3, 2, (1, 1)),
                                                (51, 1, 2, (0, 0)), (60, 5, 1, (2, 2))])
def test_same_pads_follow_flax(size, k, stride, want):
    assert same_pads(size, k, stride) == want
    # the output length is ceil(size / stride), as flax's 'SAME'
    lo, hi = want
    assert (size + lo + hi - k) // stride + 1 == -(-size // stride)


def test_state_dict_from_flax_maps_2d_kernels_axis_by_axis():
    """A flax 2-D kernel (kh, kw, Cin, Cout) becomes (Cout, Cin, kh, kw): checked
    on a non-square kernel, where a plain transpose would swap kh and kw."""
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    params = {"conv1": {"kernel": k, "bias": np.zeros(5, np.float32)}}
    w = state_dict_from_flax(params, {}, "lcnn_lfcc")["conv1.weight"].numpy()
    assert w.shape == (5, 4, 2, 3)
    for co, ci, i, j in ((4, 3, 1, 2), (0, 1, 0, 1), (2, 0, 1, 0)):
        assert w[co, ci, i, j] == k[i, j, ci, co]
    with pytest.raises(KeyError):
        state_dict_from_flax(params, {}, "maze9")      # no such registry model


def test_cli_evaluate_lcnn1d_on_cpu_and_checkpoint_round_trip(fixture_dir, tmp_path,
                                                               capsys):
    """The evaluate CLI scores the protocol with lcnn1d_lfcc on the CPU (one
    finite score per utterance, in order, and an EER); a model.pt written by
    save_checkpoint from the same seed gives the same score file."""
    ev = fixture_dir["eval"]
    base = ["--model_type", "lcnn1d_lfcc", "--protocol", ev["protocol"],
            "--data_dir", ev["audio_dir"], "--batch_size", "8", "--cut", str(CUT),
            "--device", "cpu"]
    out = tmp_path / "random.txt"
    assert evaluate.main(base + ["--output", str(out), "--seed", "3", "--smoke_test"]) == 0
    assert "'eer'" in capsys.readouterr().out
    lines = [ln.split() for ln in out.read_text().splitlines()]
    assert [u for u, _ in lines] == ev["utt_ids"]
    assert np.isfinite([float(s) for _, s in lines]).all()

    exp = make_experiment("lcnn1d_lfcc")
    exp.data.cut = CUT
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), exp, build_model(exp.model, device="cpu", seed=3))
    exp2, state = load_checkpoint(str(ckpt))
    assert exp2.model.name == "lcnn1d_lfcc" and exp2.model.frontend.name == "lfcc"
    out2 = tmp_path / "ckpt.txt"
    assert evaluate.main(base + ["--output", str(out2), "--model_path", str(ckpt)]) == 0
    assert out2.read_text() == out.read_text()
