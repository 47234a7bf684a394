"""Activation checkpointing in the port (``ops/remat.py``): ``train.remat``
and the Wav2Vec2 encoder's ``remat_layers`` / ``remat_extractor``.

- The remat step against the plain step of the port, exactly
  (``torch.equal``): loss, every gradient, every BN buffer after the step and
  each generator's state after it. maze5 at cut 4000, batch 4, with its
  dropout and SpecAugment on (bf16 as configured, and f32); RawNet ``main``
  with the fused training front end (K3's trainable wrapper, its plain
  version on the CPU); lcnn1d_lfcc (the model of tests/test_train.py:237).
- The remat step against adfmsl's ``train.remat=True`` step at dropout 0:
  tests/test_torch_train_step.py's checks and tolerances (loss within 1e-5
  relative, per-leaf gradient cosine and norm, the global update, the BN
  statistics), the counterparts of tests/test_train_parity.py's three.
- maze6 at ``wav2vec2.model_name='tiny'`` (its transformer cut to 2 layers on
  both sides, as tests/test_torch_w2v2_family.py does) with ``freeze=False``:
  the step with ``remat_layers`` and ``remat_extractor`` equals the step
  without them exactly, and its encoder gradients hold against adfmsl's
  step with both flags (tests/test_w2v2.py:98) at the f32 tolerances.
- The helper itself: a recompute replays the generators' draws and leaves
  them where the forward left them, moves no BN statistic, and outside
  autograd or in eval mode nothing is checkpointed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_train_step as tts
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import MazeModel, build_model
from adfmsl_torch.models.mazes import SPECS
from adfmsl_torch.train import Optimizer, TrainState, make_train_step
from test_torch_train_step import F32_TOL, batch, compare_grads, port_grads
from test_torch_w2v2_family import cut_spec, jax_model, no_dropout, port_model

CUT, BATCH = 4000, 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _snapshot(model, gens, met):
    return {"loss": met["loss"].clone(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "generators": {k: g.get_state() for k, g in gens.items()}}


def _step_once(exp, build, remat_on, x, y, m):
    exp.train.remat = remat_on
    model = build(exp)
    st = TrainState(model, Optimizer.for_model(exp, model, 10, 1), seed=0)
    gens = st.generators(0, 0)
    met = make_train_step(exp)(st, x, y, m, gens)
    assert float(met["skipped"]) == 0.0 and torch.isfinite(met["loss"])
    return _snapshot(model, gens, met)


def _assert_equal_steps(a, b):
    assert torch.equal(a["loss"], b["loss"])
    assert a["grads"].keys() == b["grads"].keys()
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
    for k in a["buffers"]:
        assert torch.equal(a["buffers"][k], b["buffers"][k]), k
    for k in a["generators"]:
        assert torch.equal(a["generators"][k], b["generators"][k]), k


def _batch(seed):
    x, y, m = batch(seed)
    return torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(m)


@pytest.mark.parametrize("name,dtype,extra", [
    ("maze5", "bfloat16", {}), ("maze5", "float32", {}),
    ("main", "bfloat16", {"fused_train_frontend": True}),
    ("lcnn1d_lfcc", "bfloat16", {})])
def test_remat_step_equals_plain_step(name, dtype, extra):
    """The randomness stays on (maze5: dropout 0.3 / 0.5 and SpecAugment), so
    equal gradients mean the recompute drew the forward's masks."""
    def build(exp):
        exp.data.cut = CUT
        exp.model.dtype = dtype
        exp.model.extra.update(extra)
        return build_model(exp.model, device="cpu", seed=0)

    x, y, m = _batch(1)
    # a step first, not compared: a process's first oneDNN calls on a loaded
    # host do not always round as its later ones do
    _step_once(make_experiment(name), build, False, x, y, m)
    plain = _step_once(make_experiment(name), build, False, x, y, m)
    rem = _step_once(make_experiment(name), build, True, x, y, m)
    _assert_equal_steps(plain, rem)
    if name == "maze5":
        exp = make_experiment(name)
        assert exp.model.spec_augment.enabled and exp.model.architecture.dropout_rate > 0
    # the step moved the statistics once, as the plain step does
    fresh = build(make_experiment(name))
    moved = [k for k, v in fresh.named_buffers() if k.endswith("running_mean")
             and not torch.equal(v, rem["buffers"][k])]
    assert moved


def test_remat_step_matches_adfmsl_remat_step():
    """maze5, f32, randomness off: the port's remat step against adfmsl's
    ``train.remat=True`` step (and its plain gradient)."""
    def remat_on(exp):
        exp.train.remat = True

    jr, st, _ = tts.one_step("maze5", "float32", F32_TOL, remat_on, seed=4)
    assert jr.exp.train.remat and st.step == 1


def _maze6(exp):
    no_dropout(exp)
    w = exp.model.wav2vec2
    w.freeze, w.unfreeze_last_n = False, 2
    return exp


def test_maze6_encoder_remat_equals_plain_and_adfmsl(monkeypatch):
    """maze6 (tiny encoder, unfrozen, five taps) with ``remat_layers`` and
    ``remat_extractor``: the step equals the plain one exactly; its encoder
    gradients against adfmsl's remat step."""
    x, y, m = _batch(2)
    runs = {}
    for flags in (False, True):
        exp = _maze6(tts.deterministic(make_experiment("maze6"), "float32"))
        exp.model.wav2vec2.remat_layers = exp.model.wav2vec2.remat_extractor = flags
        runs[flags] = _step_once(
            exp, lambda e: MazeModel(cut_spec(SPECS, "maze6"), e.model, device="cpu",
                                     generator=torch.Generator().manual_seed(0)),
            False, x, y, m)
    _assert_equal_steps(runs[False], runs[True])

    def configure(exp):
        _maze6(exp)
        exp.model.wav2vec2.remat_layers = exp.model.wav2vec2.remat_extractor = True

    monkeypatch.setattr(tts, "jax_build_model", jax_model)
    jr = tts.JaxRun("maze6", "float32", configure)
    xn, yn, mn = batch(2)
    _, ref_g = jr.grad(jr.params, jr.stats, jnp.asarray(xn), jnp.asarray(yn),
                       jnp.asarray(mn))
    new, jmet = jr.step(jr.state, jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(mn),
                        jax.random.PRNGKey(1))
    exp = tts.deterministic(make_experiment("maze6"), "float32")
    configure(exp)
    model = port_model(exp.model)
    model.load_state_dict(jr.to_port(jr.params, jr.stats), strict=True)
    st = TrainState(model, Optimizer.for_model(exp, model, 10), seed=0)
    met = make_train_step(exp)(st, x, y, m)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=F32_TOL["loss"])
    enc = lambda d: {k: v for k, v in d.items() if k.startswith("wav2vec2.")}  # noqa: E731
    ref = enc({k: v.numpy() for k, v in jr.to_port(ref_g, jr.stats).items()})
    got = enc(port_grads(st, met))
    assert len(got) == len(ref) >= 20
    compare_grads(got, ref, F32_TOL)


class _Toy(torch.nn.Module):
    def __init__(self):
        from adfmsl_torch.ops.norm import batch_norm

        super().__init__()
        self.lin = torch.nn.Linear(8, 8)
        self.bn = batch_norm(8)

    def forward(self, x, rngs):
        from adfmsl_torch.ops.dropout import dropout
        from adfmsl_torch.ops.norm import bn_train

        h = bn_train(self.lin(x), self.bn, torch.float32)
        return dropout(h, 0.5, rngs["dropout"], True).sum()


@pytest.mark.parametrize("checkpointed", [False, True])
def test_recompute_replays_generators_and_leaves_bn_alone(checkpointed):
    """One draw after the checkpointed call: the generator ends where a plain
    run leaves it, the gradient is the plain one, and the running mean moved
    once."""
    from adfmsl_torch.ops import remat

    torch.manual_seed(0)
    toy = _Toy()
    x = torch.randn(6, 8)
    g = torch.Generator().manual_seed(3)
    rngs = {"dropout": g, "unused": None}
    if checkpointed:
        y = remat.checkpoint(toy, x, rngs, generators=rngs)
    else:
        y = toy(x, rngs)
    after_forward = torch.rand(3, generator=g)
    y.backward()
    assert not remat.recomputing()
    torch.manual_seed(0)
    ref = _Toy()
    g2 = torch.Generator().manual_seed(3)
    ref(x, {"dropout": g2}).backward()
    assert torch.equal(after_forward, torch.rand(3, generator=g2))
    assert torch.equal(g.get_state(), g2.get_state())
    assert torch.equal(toy.lin.weight.grad, ref.lin.weight.grad)
    assert torch.equal(toy.bn.running_mean, ref.bn.running_mean)
    assert not torch.equal(toy.bn.running_mean, torch.zeros(8))


def test_no_checkpoint_outside_autograd_or_training(monkeypatch):
    """Under ``no_grad`` the helper calls ``fn`` plainly; an encoder in eval
    mode never reaches it."""
    from adfmsl_torch.ops import remat

    calls = []
    monkeypatch.setattr(remat.tcp, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](*a[1:]))
    with torch.no_grad():
        assert remat.checkpoint(lambda t: t + 1, torch.zeros(2)).sum() == 2
    assert not calls
    from adfmsl_torch.models import w2v2

    monkeypatch.setattr(w2v2, "checkpoint",
                        lambda fn, *a, **k: calls.append(1) or fn(*a, **k))
    enc = w2v2.Wav2Vec2Encoder(w2v2.W2V2Arch.tiny(), remat_layers=True,
                               remat_extractor=True)
    x = torch.randn(1, 4000)
    enc.eval()
    enc(x)
    assert not calls
    enc.train()
    enc(x)
    assert len(calls) == 1 + enc.arch.num_layers
