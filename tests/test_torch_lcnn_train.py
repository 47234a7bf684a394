"""One train step of the LFCC / log-mel models (lcnn_lfcc, lcnn1d_lfcc,
resnet18_logmel) in the port against adfmsl's ``make_train_step``.

Full width, cut 15840 (tests/test_torch_lcnn.py's: 100 frames), batch 4,
each model with its standardized loss and optimizer (weighted CE [0.1, 0.9]
divided by the summed target weights; Adam with coupled L2, lr 1e-4, wd 1e-4,
clip 1), from adfmsl's init carried across by ``state_dict_from_flax``. The
randomness is off: the LCNN heads' dropout has adfmsl's fixed rate 0.5
(``lcnn.py:71, :126``), which no configuration sets, so adfmsl's
``nn.Dropout`` is replaced by the identity while this module runs and the
port's ``head_dropout`` is set to 0. The f32 steps pin the DFT tier to
'highest' (adfmsl on the CPU computes every tier in f32); the bf16 steps keep
the default 'high'. The front end is outside autograd on both sides.

Tolerances: those of tests/test_torch_train_step.py (f32, ``F32_TOL``; every
BN statistic is compared, 10 of them for the LCNNs) and
tests/test_torch_train_step_bf16.py (bf16, ``BF16_TOL``, against the envelope
of adfmsl's own bf16 step over four copies of the batch, as
tests/test_torch_rawnet_train.py holds RawNet main). Then one step with
the dropout on (port only: the two generators never agree bit for bit): a
finite loss, drawn from the generator given, so that the same generator gives
the same loss twice and another seed another loss. And ``ops/norm.py:
bn_train`` over the last axis of (B, H, W, C) and (B, T, C) maps against
flax's train BatchNorm: f32 statistics over every other axis, the fast
variance, the running statistics moved with the biased batch variance, and
the gradients.
"""
import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from test_torch_rawnet_train import bf16_draws, check_bf16_envelope, strict_bf16
from test_torch_train_step import (F32_TOL, JaxRun, compare_grads, compare_updates,
                                   port_grads, port_state)
from test_torch_train_step_bf16 import BF16_TOL
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model
from adfmsl_torch.ops.norm import batch_norm, bn_train
from adfmsl_torch.train import make_train_step

CUT, BATCH = 15840, 4
NAMES = ["lcnn_lfcc", "lcnn1d_lfcc", "resnet18_logmel"]
PRECISION = {"float32": "highest", "bfloat16": "high"}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _adfmsl_without_dropout():
    """adfmsl's LCNN heads look ``nn.Dropout`` up on flax.linen when they are
    traced: the identity takes its place while this module runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn, "Dropout", lambda *args, **kwargs: (lambda h: h))
    yield
    mp.undo()


def spectral_batch(seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((BATCH, CUT))).astype(np.float32)
    return x, np.array([0, 1, 0, 1], np.int32), np.ones(BATCH, bool)


def configure(dtype):
    def apply(exp):
        exp.data.cut = CUT
        exp.model.frontend.dsp_precision = PRECISION[dtype]
    return apply


_RUNS = {}


def jax_run(name, dtype):
    """adfmsl's run of a configuration, built once per module."""
    if (name, dtype) not in _RUNS:
        jr = JaxRun(name, dtype, configure(dtype))
        _RUNS[name, dtype] = strict_bf16(jr) if dtype == "bfloat16" else jr
    return _RUNS[name, dtype]


def port_step(jr, dtype, x, y, m):
    exp, st = port_state(jr, dtype, configure(dtype))
    if hasattr(st.model, "head_dropout"):
        st.model.head_dropout = 0.0
    assert exp.train.optimizer.name == "adam" and exp.train.loss.name == "weighted_ce"
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    assert st.step == 1 and float(met["skipped"]) == 0.0
    return st, met, pre


@pytest.mark.parametrize("name", NAMES)
def test_one_step_f32_matches_adfmsl(name):
    tol = F32_TOL
    jr = jax_run(name, "float32")
    x, y, m = spectral_batch(0)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    ref_loss, ref_g = jr.grad(jr.params, jr.stats, jx, jy, jm)
    new, jmet = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))
    st, met, pre = port_step(jr, "float32", x, y, m)
    loss = float(met["loss"])
    np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=tol["loss"])
    np.testing.assert_allclose(loss, float(ref_loss), rtol=tol["loss"])
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=tol["ratio"])
    ref_grads = {k: v.numpy() for k, v in jr.to_port(ref_g, jr.stats).items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    compare_grads(port_grads(st, met), ref_grads, tol)
    post = st.model.state_dict()
    ref_post = jr.to_port(new.params, new.batch_stats)
    compare_updates(pre, post, jr.to_port(jr.params, jr.stats), ref_post, tol)
    n = 0
    for key, r in ref_post.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(post[key].numpy(), r.numpy(), rtol=0,
                                       atol=tol["stats"] * max(1.0, float(r.abs().max())),
                                       err_msg=key)
            n += 1
    assert n == sum(isinstance(mod, torch.nn.BatchNorm1d) for mod in st.model.modules()) * 2


@pytest.mark.parametrize("name", NAMES)
def test_one_step_bf16_matches_adfmsl(name):
    """tests/test_torch_train_step_bf16.py's checks (``BF16_TOL``), held
    against the envelope adfmsl's own bf16 step (compiled without excess
    precision) spans over four copies of the batch
    (tests/test_torch_rawnet_train.py:check_bf16_envelope): one draw does not
    tell two bf16 paths apart here either. The small BN-parameter leaves move
    most: the cosine of resnet18_logmel's layer0_0 bn1 scale to its f32
    gradient ranged 0.86-0.88 over adfmsl's draws and 0.81-0.87 over the
    port's."""
    j32, j16 = jax_run(name, "float32"), jax_run(name, "bfloat16")
    runs, keys = bf16_draws(j32, j16, lambda x, y, m: port_step(j16, "bfloat16", x, y, m),
                            spectral_batch(0), skip=None)
    n_bn = sum(k.endswith("running_var") for k in runs["f32"][0]["post"])
    check_bf16_envelope(runs, keys, BF16_TOL, name, min_leaves=5, min_stats=2 * n_bn)


@pytest.mark.parametrize("name", ["lcnn_lfcc", "lcnn1d_lfcc"])
def test_head_dropout_draws_from_the_generator(name):
    """One train-mode forward with the heads' dropout at adfmsl's 0.5: a
    finite loss, the same for the same 'dropout' generator, another for
    another seed and another without the dropout."""
    exp = make_experiment(name)
    exp.data.cut = CUT
    model = build_model(exp.model, device="cpu", seed=0).train()
    assert model.head_dropout == 0.5
    x, y, m = (torch.from_numpy(a) for a in spectral_batch(1))
    stats = {k: v.clone() for k, v in model.named_buffers()}
    step = make_train_step(exp)

    def loss(seed):
        model.load_state_dict({**model.state_dict(), **stats})
        gens = {"dropout": torch.Generator().manual_seed(seed)} if seed is not None else None
        with torch.no_grad():
            out = model(x, labels=y.long(), mask=m, rngs=gens)
        assert tuple(out["features"].shape) == (BATCH, 80)
        return float(torch.nn.functional.cross_entropy(out["logits"], y.long()))

    a, b, c = loss(1), loss(1), loss(2)
    assert np.isfinite(a) and a == b and a != c
    with pytest.raises(ValueError, match="generator"):
        loss(None)
    model.head_dropout = 0.0
    assert loss(None) != a
    # and through the real step, which hands the stream to the model
    from adfmsl_torch.train import Optimizer, TrainState

    model.head_dropout = 0.5
    st = TrainState(model, Optimizer(exp.train.optimizer, model.parameters(), 10, 1), seed=0)
    met = step(st, x, y.long(), m, st.generators(0, 0))
    assert np.isfinite(float(met["loss"])) and float(met["skipped"]) == 0.0


@pytest.mark.parametrize("shape", [(4, 13, 7, 32), (3, 50, 48)], ids=["bhwc", "btc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_matches_flax(shape, dtype):
    """bn_train over the last axis against flax's ``nn.BatchNorm(
    use_running_average=False, momentum=0.9, dtype=...)``: output within one
    ulp of its dtype (f32 within 1e-5 * max), running statistics within 1e-6,
    gradients of x, scale and bias within 1e-5 * max (f32; bf16 outputs make
    the gradients' cotangent the same bf16 values on both sides)."""
    rng = np.random.default_rng(7)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn_flax = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def loss(params, xin):
        y, upd = bn_flax.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               xin, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd)
    xj = jnp.asarray(x).astype(jdt)
    (_, (ref_y, upd)), (ref_gp, ref_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], xj)

    bn = batch_norm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt).requires_grad_(True)
    y = bn_train(xt, bn, tdt)
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(g)).sum().backward()

    ref_y = np.asarray(ref_y.astype(jnp.float32))
    atol = (2.0 ** -7 if dtype == "bfloat16" else 1e-5) * np.abs(ref_y).max()
    np.testing.assert_allclose(y.detach().float().numpy(), ref_y, rtol=0, atol=atol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    for got, ref in ((bn.weight.grad, ref_gp["scale"]), (bn.bias.grad, ref_gp["bias"]),
                     (xt.grad.float(), ref_gx.astype(jnp.float32))):
        ref = np.asarray(ref)
        rel = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())
