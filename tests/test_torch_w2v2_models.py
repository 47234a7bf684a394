"""maze7, maze7_fmsl and maze3 (the Wav2Vec2 front end, the 1x1 ``proj``
conv, the SE-ResBlock trunk, maze3's ReLU after fc1, the 'integrated' FMSL
head) against adfmsl's, at ``wav2vec2.model_name='tiny'`` (W2V2Arch.tiny:
2 conv and 2 transformer layers, hidden 64), full trunk and head widths.
adfmsl's variables come across by ``state_dict_from_flax``.

- Logits at cut 4000, batch 2: f32 within 1e-4 * max(1, |logits|) of
  adfmsl's plain path. bf16 through the folded trunk (K1's plain version on
  the CPU) within 3e-2 * max(1, |logits|) (tests/test_pallas.py:185) of
  adfmsl's exact f32 logits, and of adfmsl's bf16 fused_eval_trunk logits
  give or take adfmsl's own bf16 error: the bf16 encoder's roundings, through
  BN statistics far from the data's, move adfmsl's bf16 maze7 logits 4.7 % of
  their peak from its f32 ones (the port's: 1.2 %), so the two bf16 sides
  may differ by that much more.
- One f32 train step at cut 4000, batch 4, randomness off, with the checks
  and tolerances of tests/test_torch_train_step.py (loss, per-leaf gradient
  cosine and norm, global update cosine and magnitude, BN statistics): maze7
  and maze3 with the encoder frozen (the default: its parameters unchanged on
  both sides), and maze7 with ``freeze=False, unfreeze_last_n=1``, where the
  last encoder layer trains at ``lr * backbone_lr_scale`` and the rest is
  frozen although its gradients are not zero.
- The optimizer's labels ('main', 'backbone', 'frozen') against adfmsl's
  ``param_labels``.
- ``cli.train`` + ``--restore`` + ``cli.evaluate`` for maze7 on the CPU.
- One forward of either model enters the front-end, trunk and head spans in
  order.

The card test of their folded trunks is in test_torch_w2v2_card.py.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl.train.optim import param_labels as jax_param_labels
from adfmsl_torch.config import make_experiment
from adfmsl_torch.data import SyntheticSpec, generate_fixture
from adfmsl_torch.models import build_model, state_dict_from_flax
from adfmsl_torch.train import Optimizer, TrainState, make_train_step, param_labels
from test_torch_telemetry import check_model_stages
from test_torch_train_step import (F32_TOL, JaxRun, batch, compare_grads, compare_updates,
                                   deterministic, port_grads)

CUT = 4000
NAMES = ["maze7", "maze7_fmsl", "maze3"]
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(exp):
    exp.model.wav2vec2.model_name = "tiny"
    exp.data.cut = CUT
    return exp


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def variables():
    """Per model: adfmsl variables with non-trivial BN running stats, the
    input batch and adfmsl's f32 and bf16-fused logits. fc2 is scaled so the
    logits are O(1); maze7_fmsl's logits are s * cos (s 5), so its class
    weights are aimed at the batch's mean embedding (+/-)."""
    rng = np.random.default_rng(2025)
    out = {}
    for name in NAMES:
        x = rng.standard_normal((2, CUT)).astype(np.float32)
        model = jax_build_model(tiny(jax_experiment(name)).model)
        v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x))
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
        for dtype, fused in (("float32", False), ("bfloat16", True)):
            e = tiny(jax_experiment(name))
            e.model.dtype = dtype
            e.model.extra["fused_eval_trunk"] = fused
            m = jax_build_model(e.model)
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
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(v["params"], v["stats"], name), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(v["x"]))
    got, ref, exact = out["logits"].float().numpy(), v["logits"][dtype], v["logits"]["float32"]
    assert np.abs(ref).max() > 0.3                 # the tolerance bites
    atol = tol * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, exact, rtol=0, atol=atol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol + np.abs(ref - exact).max())
    assert out["scores"].shape == (2,)


def unfreeze_last(exp):
    tiny(exp)
    exp.model.wav2vec2.freeze = False
    exp.model.wav2vec2.unfreeze_last_n = 1


STEP_CASES = {"maze7": ("maze7", tiny), "maze3": ("maze3", tiny),
              "maze7_unfreeze_last_1": ("maze7", unfreeze_last)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_adfmsl(case):
    name, configure = STEP_CASES[case]
    jr = JaxRun(name, "float32", configure)
    x, y, m = batch(0)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    ref_loss, ref_g = jr.grad(jr.params, jr.stats, jx, jy, jm)
    new, jmet = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))

    exp = deterministic(make_experiment(name), "float32")
    configure(exp)
    model = build_model(exp.model, device="cpu")
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

    # the encoder: frozen leaves unchanged on both sides; with unfreeze_last_n
    # the last layer moves on both sides
    labels = param_labels(exp.model.wav2vec2, model)
    enc = [k for k in labels if k.startswith("wav2vec2.")]
    assert enc and all(labels[k] != "main" for k in enc)
    for k in enc:
        moved = (not torch.equal(post[k], pre[k]), not torch.equal(ref_post[k], ref_pre[k]))
        assert moved == ((labels[k] == "backbone"),) * 2, (k, moved)
    assert any(labels[k] == "backbone" for k in enc) == (case == "maze7_unfreeze_last_1")


LABEL_CASES = {"freeze": {}, "no_freeze": {"freeze": False},
               "last_1": {"unfreeze_last_n": 1},
               "last_1_extractor": {"unfreeze_last_n": 1, "unfreeze_feature_extractor": True}}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_param_groups_match_adfmsl_labels(case):
    """Each parameter's group: adfmsl's label tree, carried across as a
    tree of label codes by ``state_dict_from_flax``."""
    codes = {"main": 0.0, "backbone": 1.0, "frozen": 2.0}
    exp = tiny(jax_experiment("maze7"))
    for k, v in LABEL_CASES[case].items():
        setattr(exp.model.wav2vec2, k, v)
    model = jax_build_model(exp.model)
    v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, CUT), jnp.float32))
    labels = jax_param_labels(exp, v["params"])
    coded = jax.tree.map(lambda p, lb: np.full(p.shape, codes[lb], np.float32),
                         v["params"], labels)
    sd = state_dict_from_flax(coded, _np(v["batch_stats"]), "maze7")
    pexp = tiny(make_experiment("maze7"))
    for k, v in LABEL_CASES[case].items():
        setattr(pexp.model.wav2vec2, k, v)
    port = build_model(pexp.model, device="cpu")
    ours = param_labels(pexp.model.wav2vec2, port)
    assert set(ours) == {n for n, _ in port.named_parameters()}
    for n, lb in ours.items():
        assert torch.all(sd[n] == codes[lb]), (n, lb)
    opt = Optimizer.for_model(pexp, port, 4)
    grouped = {id(p) for g in opt.opt.param_groups for p in g["params"]}
    for n, p in port.named_parameters():
        assert (id(p) in grouped) == (ours[n] != "frozen"), n
    assert len(opt.params) == len(ours)            # the clip sees every gradient


@pytest.fixture
def small_tiny_experiments(monkeypatch):
    import adfmsl_torch.config as config

    make = config.make_experiment

    def small(*a, **k):
        exp = tiny(make(*a, **k))
        exp.data.prefetch = 0
        exp.train.batch_size = 4
        exp.train.log_every_steps = 0
        return exp
    monkeypatch.setattr(config, "make_experiment", small)


def test_cli_train_restore_and_evaluate_maze7(small_tiny_experiments, tmp_path):
    from adfmsl_torch.cli import evaluate
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.models import load_checkpoint
    from adfmsl_torch.train import CheckpointManager

    fx = generate_fixture(str(tmp_path / "fx"), SyntheticSpec(n_train=8, n_dev=4, n_eval=6))
    ck = str(tmp_path / "ck")
    tr, dv, ev = fx["train"], fx["dev"], fx["eval"]
    argv = ["--model", "maze7", "--train_protocol", tr["protocol"], "--train_dir",
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
        exp, states[epoch] = load_checkpoint(os.path.join(ck, f"epoch_{epoch}"))
    assert exp.model.wav2vec2.model_name == "tiny" and exp.model.wav2vec2.freeze
    init = build_model(exp.model, device="cpu", seed=exp.train.seed).state_dict()
    for a, b in ((init, states[0]), (states[0], states[1])):
        for k, v in b.items():
            if k.endswith("num_batches_tracked"):
                continue
            # the frozen encoder stays as initialised; everything else trains
            assert torch.equal(v, a[k]) == k.startswith("wav2vec2."), k
    out = str(tmp_path / "scores.txt")
    assert evaluate.main(["--model_type", "maze7", "--model_path", ck, "--protocol",
                          ev["protocol"], "--data_dir", ev["audio_dir"], "--output", out,
                          "--batch_size", "4", "--device", "cpu"]) == 0
    lines = [ln.split() for ln in open(out).read().splitlines()]
    assert [ln[0] for ln in lines] == ev["utt_ids"]
    assert np.isfinite([float(ln[1]) for ln in lines]).all()


@pytest.mark.parametrize("name", ["maze7", "maze3"])
def test_forward_enters_the_model_stage_spans_in_order(name):
    check_model_stages(build_model(tiny(make_experiment(name)).model, device="cpu"),
                       torch.zeros((1, CUT)))
