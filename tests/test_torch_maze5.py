"""maze5 / maze5_fmsl and maze4 / maze4_fmsl end to end: the port's MazeModel
vs adfmsl's on the same weights and inputs, at full width (128 sinc filters,
K=251, blocks 128->...->256, fc1 1024; FMSL refine head at 1024 for
maze5_fmsl, the 'integrated' head at the pooled 256 for maze4_fmsl, 3
prototypes) and cut 6000, batch 2. Weights go adfmsl init -> numpy ->
state_dict_from_flax -> load_state_dict(strict=True).

Tolerances: f32 logits within 1e-4 * max(1, |logits|) of adfmsl's plain path;
bf16 logits through the folded trunk (K1's plain version on the CPU) within
3e-2 * max(1, |logits|) of adfmsl's fused_eval_trunk path (test_pallas.py:185).
Logits, not scores: log-softmax amplifies near-tied logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import MazeModel, SPECS, build_model, state_dict_from_flax

CUT = 6000
NAMES = ["maze5", "maze5_fmsl", "maze4", "maze4_fmsl"]


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def variables():
    """Per model: adfmsl variables with non-trivial BN running stats (as
    test_pallas.py:120-129), the input batch, and adfmsl's f32 and bf16-fused
    logits. The FMSL head's proj_bn mean is zero-centred so its ReLU passes
    about half the units (a positive mean there zeroes every embedding), and
    fc2 is scaled so the logits are O(1) and the tolerances bite; maze4_fmsl
    has no fc2, its logits are s*cos with s=2 (its FMSL drift), and its class
    weights are set so that |cos| is near 1."""
    rng = np.random.default_rng(2024)
    out = {}
    for name in NAMES:
        x = rng.standard_normal((2, CUT)).astype(np.float32)
        exp = jax_experiment(name)
        exp.data.cut = CUT
        model = jax_build_model(exp.model)
        v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x))
        params = _numpy_tree(v["params"])
        stats = jax.tree.map(
            lambda a: np.abs(rng.standard_normal(a.shape).astype(np.float32) * 0.3)
            + 0.1, _numpy_tree(v["batch_stats"]))
        if "fmsl" in stats:
            mean = stats["fmsl"]["proj_bn"]["mean"]
            stats["fmsl"]["proj_bn"]["mean"] = (
                rng.standard_normal(mean.shape).astype(np.float32) * 0.01)
        if "fc2" in params:
            params["fc2"]["kernel"] = params["fc2"]["kernel"] * 30.0
        else:
            # logits are s*cos: aim the class weights at the batch's mean
            # embedding (+/-), so |cos| is near 1
            emb = model.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)["features"]
            w = np.asarray(emb, np.float32).mean(axis=0)
            params["fmsl"]["weight"] = np.stack([-w, w]) + (
                rng.standard_normal((2, w.size)).astype(np.float32) * 0.01)
        logits = {}
        for dtype, fused in (("float32", False), ("bfloat16", True)):
            e = jax_experiment(name)
            e.data.cut = CUT
            e.model.dtype = dtype
            e.model.extra["fused_eval_trunk"] = fused
            m = jax_build_model(e.model)
            res = jax.jit(lambda v, x: m.apply(v, x, train=False))(
                {"params": params, "batch_stats": stats}, jnp.asarray(x))
            logits[dtype] = np.asarray(res["logits"], np.float32)
        out[name] = {"x": x, "params": params, "stats": stats, "logits": logits}
    return out


def _port_logits(name, v, dtype, fused):
    exp = make_experiment(name)
    exp.data.cut = CUT
    exp.model.dtype = dtype
    exp.model.extra["fused_eval_trunk"] = fused
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(v["params"], v["stats"], name),
                          strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(v["x"]))
    feat_dim = 256 if name == "maze4_fmsl" else 1024
    assert out["scores"].shape == (2,) and out["features"].shape == (2, feat_dim)
    return out["logits"].float().numpy()


@pytest.mark.parametrize("name", NAMES)
def test_f32_logits_match_adfmsl(variables, name):
    v = variables[name]
    ref = v["logits"]["float32"]
    assert 0.5 < np.abs(ref).max() < 50          # O(1) logits: the check bites
    got = _port_logits(name, v, "float32", False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", NAMES)
def test_bf16_folded_trunk_logits_match_adfmsl(variables, name):
    v = variables[name]
    ref = v["logits"]["bfloat16"]
    got = _port_logits(name, v, "bfloat16", True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name,n_params,n_stats", [("maze5", 58, 20),
                                                   ("maze5_fmsl", 65, 22),
                                                   ("maze4", 58, 20),
                                                   ("maze4_fmsl", 61, 22)])
def test_state_dict_covers_every_flax_leaf(variables, name, n_params, n_stats):
    v = variables[name]
    assert len(jax.tree.leaves(v["params"])) == n_params
    assert len(jax.tree.leaves(v["stats"])) == n_stats
    sd = state_dict_from_flax(v["params"], v["stats"], name)
    n_bn = n_stats // 2
    assert len(sd) == n_params + n_stats + n_bn           # + num_batches_tracked
    assert tuple(sd["trunk.block4.conv2.weight"].shape) == (256, 256, 3)
    assert tuple(sd["trunk.block4.downsample.weight"].shape) == (256, 128, 1)
    assert tuple(sd["trunk.block0.se.fc1.weight"].shape) == (8, 128)
    assert "trunk.block0.bn1.weight" not in sd and "trunk.block3.downsample.weight" not in sd
    np.testing.assert_array_equal(sd["trunk.block4.conv2.weight"].numpy(),
                                  v["params"]["trunk"]["block4"]["conv2"]["kernel"]
                                  .transpose(2, 1, 0))
    if name == "maze5_fmsl":
        assert tuple(sd["fmsl.prototypes"].shape) == (3, 1024)
        assert tuple(sd["fmsl.temperature"].shape) == ()
    if name == "maze4_fmsl":
        assert tuple(sd["fmsl.prototypes"].shape) == (3, 256)
        assert not any(k.startswith(("fc1.", "fc2.")) for k in sd)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device='cpu' the model is built on 'cuda', and a host without a
    visible card raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_experiment("maze5").model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MazeModel(SPECS["maze5"], cfg)


def test_unported_models_name_their_slice():
    """Every registry model is ported, and so are the two paths this test
    once pinned as raising. 'reference' block semantics (slice 9b): maze6_fmsl
    builds with its 'fmsl_plain' blocks (bias-free convs) and its eval
    forward on the tiny encoder is finite. The encoder's activation
    checkpointing (slice 6c): with the flag set the model builds and its
    train forward is finite."""
    exp = make_experiment("maze6_fmsl")
    exp.model.architecture.block_semantics = "reference"
    exp.model.wav2vec2.model_name = "tiny"
    model = build_model(exp.model, device="cpu")
    assert model.trunk.block1.semantics == "fmsl_plain"
    assert model.trunk.block1.conv1.bias is None
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out["logits"].shape == (2, 2) and torch.isfinite(out["logits"]).all()
    exp = make_experiment("maze6_fmsl")
    exp.model.wav2vec2.model_name = "tiny"
    exp.model.wav2vec2.remat_extractor = True
    model = build_model(exp.model, device="cpu")
    assert model.wav2vec2.remat_extractor
    model.train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32))
    out = model(x, labels=torch.tensor([0, 1]),
                rngs={k: torch.Generator().manual_seed(i)
                      for i, k in enumerate(("dropout", "specaugment", "lsa"))})
    assert torch.isfinite(out["logits"]).all() and torch.isfinite(out["loss"])
