"""The rest of the Wav2Vec2 family against adfmsl: maze2 / maze2_fmsl,
maze3_fmsl, maze6 / maze6_fmsl and maze8 / maze8_fmsl, at
``wav2vec2.model_name='tiny'`` (2 conv and 2 transformer layers, hidden 64;
maze6's five taps clamp to the tiny encoder's three hidden states), cut 4000,
with the models' own trunks, heads and widths. The transformer after the trunk
keeps 2 of its layers (maze2: 6, maze6: 4, maze3_fmsl: 6), cut by
``dataclasses.replace`` of the spec on both sides, as tests/test_port.py:589
does. adfmsl's variables come across by ``state_dict_from_flax``.

- Logits at batch 2: f32 within 1e-4 * max(1, |logits|) of adfmsl's; bf16
  through the folded trunk (K1's plain version on the CPU) within 3e-2 *
  max(1, |logits|) (tests/test_pallas.py:185) of adfmsl's f32 logits, and of
  adfmsl's bf16 logits give or take adfmsl's own bf16-vs-f32 gap. adfmsl's
  bf16 side runs its folded trunk too, except for maze2: its folded block
  declares block0's kernel at the spec's 768 input channels, which the tiny
  encoder's 64 do not fill, so its unfolded bf16 trunk is the reference there.
- The 'fallback' FMSL mode (maze6_fmsl's literal path for ported
  checkpoints): the logits are fc2(ReLU(fc1(pooled))) of the ASP features,
  the FMSL head still gives the embeddings, no loss comes out, and the
  logits match adfmsl's.
- One f32 train step at batch 4 with every dropout rate 0 (trunk, fc,
  transformer, FMSL projection, maze8's conv FMSL layer), SpecAugment and LSA
  off, with the checks and tolerances of tests/test_torch_train_step.py (loss,
  per-leaf gradient cosine and norm, global update cosine and magnitude, BN
  statistics): maze2 (focal CE, Adam, the encoder frozen), maze6_fmsl (its
  plateau scheduler, the FMSL 'replace' loss, the encoder unfrozen with
  ``unfreeze_last_n``: its last two layers train at ``lr *
  backbone_lr_scale``, the rest stays although its gradients are not zero)
  and maze8 (the conv FMSL layer in f32 in front of the trunk).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_train_step as tts
from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import mazes as jax_mazes
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import MazeModel, state_dict_from_flax
from adfmsl_torch.models.mazes import SPECS
from adfmsl_torch.train import Optimizer, TrainState, make_train_step, param_labels
from test_torch_telemetry import check_model_stages
from test_torch_train_step import (F32_TOL, batch, compare_grads, compare_updates,
                                   deterministic, port_grads)

CUT = 4000
NAMES = ["maze2", "maze2_fmsl", "maze3_fmsl", "maze6", "maze6_fmsl", "maze8", "maze8_fmsl"]
LAYERS_KEPT = 2
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cut_spec(specs, name):
    """The registry spec with its transformer cut to ``LAYERS_KEPT`` layers."""
    spec = specs[name]
    if spec.transformer is None:
        return spec
    d, heads, _, ff = spec.transformer
    return dataclasses.replace(spec, transformer=(d, heads, LAYERS_KEPT, ff))


def tiny(exp):
    exp.model.wav2vec2.model_name = "tiny"
    exp.data.cut = CUT
    return exp


def jax_model(cfg):
    return jax_mazes.MazeModel(spec=cut_spec(jax_mazes.SPECS, cfg.name), cfg=cfg)


def port_model(cfg):
    return MazeModel(cut_spec(SPECS, cfg.name), cfg, device="cpu")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _init(model, x):
    return jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))


@pytest.fixture(scope="module")
def variables():
    """Per model: adfmsl variables with non-trivial BN running stats, the
    input batch and adfmsl's f32 and bf16 logits. fc2 is scaled so the logits
    are O(1); an FMSL model's logits are s * cos, so its class weights are
    aimed at the batch's mean embedding (+/-)."""
    rng = np.random.default_rng(2026)
    out = {}
    for name in NAMES:
        x = rng.standard_normal((2, CUT)).astype(np.float32)
        model = jax_model(tiny(jax_experiment(name)).model)
        v = _init(model, x)
        params = _np(v["params"])
        stats = jax.tree.map(
            lambda a: np.abs(rng.standard_normal(a.shape).astype(np.float32) * 0.3) + 0.1,
            _np(v["batch_stats"]))
        if "fmsl" in stats:
            mean = stats["fmsl"]["proj_bn"]["mean"]
            stats["fmsl"]["proj_bn"]["mean"] = (
                rng.standard_normal(mean.shape).astype(np.float32) * 0.01)
        if "fc2" in params:
            params["fc2"]["kernel"] = params["fc2"]["kernel"] * 30.0
        else:
            emb = model.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)["features"]
            w = np.asarray(emb, np.float32).mean(axis=0)
            params["fmsl"]["weight"] = np.stack([-w, w]) + (
                rng.standard_normal((2, w.size)).astype(np.float32) * 0.01)
        logits = {}
        for dtype, fused in (("float32", False), ("bfloat16", name != "maze2")):
            e = tiny(jax_experiment(name))
            e.model.dtype = dtype
            e.model.extra["fused_eval_trunk"] = fused
            m = jax_model(e.model)
            res = jax.jit(lambda v, x: m.apply(v, x, train=False))(
                {"params": params, "batch_stats": stats}, jnp.asarray(x))
            logits[dtype] = np.asarray(res["logits"], np.float32)
        out[name] = {"x": x, "params": params, "stats": stats, "logits": logits}
    return out


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_adfmsl(name, dtype, tol, variables):
    v = variables[name]
    exp = tiny(make_experiment(name))
    exp.model.dtype = dtype
    exp.model.extra["fused_eval_trunk"] = dtype == "bfloat16"
    model = port_model(exp.model)
    model.load_state_dict(state_dict_from_flax(v["params"], v["stats"], name), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(v["x"]))
    got, ref, exact = out["logits"].float().numpy(), v["logits"][dtype], v["logits"]["float32"]
    assert np.abs(ref).max() > 0.3                 # the tolerance bites
    atol = tol * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, exact, rtol=0, atol=atol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol + np.abs(ref - exact).max())
    assert out["scores"].shape == (2,)
    np.testing.assert_array_equal(out["scores"].numpy(), out["logits"][:, 1].numpy()
                                  if SPECS[name].score == "logit" else
                                  torch.log_softmax(out["logits"], -1)[:, 1].numpy())


def test_fallback_mode_scores_through_fc1_relu_fc2(variables):
    name = "maze6_fmsl"
    v = variables[name]
    x = v["x"]
    rng = np.random.default_rng(3)
    params = dict(v["params"])
    # 'fallback' adds fc1 (512 -> 1024) and fc2 (1024 -> 2) to the tree
    for fc, shape in (("fc1", (512, 1024)), ("fc2", (1024, 2))):
        params[fc] = {"kernel": rng.standard_normal(shape).astype(np.float32)
                      / np.sqrt(shape[0]) * (30.0 if fc == "fc2" else 1.0),
                      "bias": rng.standard_normal(shape[1]).astype(np.float32) * 0.1}
    e = tiny(jax_experiment(name))
    e.model.dtype = "float32"
    e.model.fmsl.mode = "fallback"
    m = jax_model(e.model)
    ref = m.apply({"params": params, "batch_stats": v["stats"]}, jnp.asarray(x),
                  labels=jnp.asarray([0, 1]), train=False)
    exp = tiny(make_experiment(name))
    exp.model.dtype = "float32"
    exp.model.fmsl.mode = "fallback"
    model = port_model(exp.model)
    model.load_state_dict(state_dict_from_flax(params, v["stats"], name), strict=True)
    pooled = []
    model.asp.register_forward_hook(lambda mod, a, o: pooled.append(o))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), labels=torch.tensor([0, 1]))
        want = model.fc2(torch.relu(model.fc1(pooled[0])))
        emb = model.fmsl(pooled[0])["embeddings"]
    assert "loss" not in out and "loss" not in ref
    torch.testing.assert_close(out["logits"], want, rtol=0, atol=0)
    torch.testing.assert_close(out["features"], emb, rtol=0, atol=0)
    got, r = out["logits"].numpy(), np.asarray(ref["logits"], np.float32)
    assert np.abs(r).max() > 0.3
    np.testing.assert_allclose(got, r, rtol=0, atol=1e-4 * max(1.0, np.abs(r).max()))
    np.testing.assert_allclose(out["scores"].numpy(), got[:, 1])


def no_dropout(exp):
    tiny(exp)
    exp.model.architecture.transformer_dropout = 0.0
    return exp


STEP_NAMES = ["maze2", "maze6_fmsl", "maze8"]


@pytest.mark.parametrize("name", STEP_NAMES)
def test_train_step_matches_adfmsl(name, monkeypatch):
    # the cut specs on adfmsl's side; maze8's conv FMSL layer has a fixed
    # dropout of 0.1 in adfmsl (blocks.py:486): 0 on both sides here
    monkeypatch.setattr(tts, "jax_build_model", jax_model)
    monkeypatch.setattr(jax_mazes, "ConvFMSLLayer",
                        functools.partial(jax_mazes.ConvFMSLLayer, dropout=0.0))
    jr = tts.JaxRun(name, "float32", no_dropout)
    x, y, m = batch(0)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    ref_loss, ref_g = jr.grad(jr.params, jr.stats, jx, jy, jm)
    new, jmet = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))

    exp = no_dropout(deterministic(make_experiment(name), "float32"))
    model = port_model(exp.model)
    if name == "maze8":
        model.conv_fmsl.dropout_rate = 0.0
    model.load_state_dict(jr.to_port(jr.params, jr.stats), strict=True)
    st = TrainState(model, Optimizer.for_model(exp, model, STEPS_PER_EPOCH), seed=0)
    pre = {k: v.detach().clone() for k, v in model.state_dict().items()}
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    assert float(met["skipped"]) == 0.0
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=F32_TOL["loss"])
    np.testing.assert_allclose(float(met["loss"]), float(ref_loss), rtol=F32_TOL["loss"])
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=F32_TOL["ratio"])
    ref_grads = {k: g.numpy() for k, g in jr.to_port(ref_g, jr.stats).items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    compare_grads(port_grads(st, met), ref_grads, F32_TOL)
    ref_pre, ref_post = jr.to_port(jr.params, jr.stats), jr.to_port(new.params, new.batch_stats)
    post = model.state_dict()
    compare_updates(pre, post, ref_pre, ref_post, F32_TOL)
    for k, r in ref_post.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(post[k].numpy(), r.numpy(), rtol=0,
                                       atol=F32_TOL["stats"] * max(1.0, float(r.abs().max())))

    # the encoder: 'frozen' leaves unchanged on both sides, 'backbone' ones
    # (maze6_fmsl's last two layers) moved on both sides
    labels = param_labels(exp.model.wav2vec2, model)
    enc = [k for k in labels if k.startswith("wav2vec2.")]
    assert enc and all(labels[k] != "main" for k in enc)
    for k in enc:
        moved = (not torch.equal(post[k], pre[k]), not torch.equal(ref_post[k], ref_pre[k]))
        assert moved == ((labels[k] == "backbone"),) * 2, (k, moved)
    assert any(labels[k] == "backbone" for k in enc) == (name == "maze6_fmsl")
    if name == "maze6_fmsl":
        assert exp.train.optimizer.scheduler == "plateau"
        assert st.optimizer.opt.param_groups[0]["lr"] > 0


@pytest.mark.parametrize("name", ["maze2", "maze3_fmsl", "maze6", "maze8"])
def test_forward_enters_the_model_stage_spans_in_order(name):
    """The encoder with the fusion ``proj`` (and maze8's conv FMSL layer) is
    the front-end span, the ResBlock stack the trunk span, the transformer,
    ASP and the head the head span."""
    check_model_stages(port_model(no_dropout(make_experiment(name)).model),
                       torch.zeros((1, CUT)))
