"""One train step of the port against adfmsl's ``make_train_step``.

maze5, maze5_fmsl, maze4 and maze4_fmsl at full width (128 sinc filters,
K=251, blocks 128->...->256, fc1 1024, the FMSL heads), cut 4000, batch 4,
each with its own loss and optimizer (focal CE + AdamW clip 1; weighted CE
[0.3, 0.7] + AdamW lr 1e-3 clip 5; weighted CE [0.1, 0.9] + AdamW; the
integrated FMSL loss + AdamW lr 1e-5), with the randomness off (dropout rates
0, SpecAugment off, LSA off): the two generators never agree bit for bit.
Both start from adfmsl's init, carried across by ``state_dict_from_flax``;
adfmsl's gradients and post-step parameters and BN statistics come back
through the same function, so everything is compared in the port's layout.

Tolerances (f32 here; bf16 in test_torch_train_step_bf16.py):
- loss within 1e-5 relative;
- per-leaf gradient cosine >= 0.999 (leaves of 512+ elements; smaller ones
  >= 0.99) and norm ratio within 1 % for leaves that carry at least 1 % of
  the global gradient norm, 5 % for the others, skipping leaves whose gradient
  is analytically zero on both sides (norm below 3e-5 of the global norm: a
  conv bias feeding a train-mode BN), as tests/test_train_parity.py does. The
  small leaves (SE gates, BN scales of early blocks) hang on a few ReLU
  decisions of an 8-unit SE layer at batch 4, which f32 rounding moves: the
  port's CPU convolutions do not even reproduce their own last bits from one
  process to the next, and block0's SE fc1 has been seen 1.7 % apart;
- the global update (every leaf's parameter delta, concatenated): cosine
  >= 0.99 and magnitude within 2 %. Adam's first step is about lr * sign(g),
  so every gradient element at f32 noise level adds a coin-flip lr-sized
  coordinate (tests/test_train_parity.py uses 0.99 and 5 %);
- BN running statistics after the step within 1e-5 * max(1, |v|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl.train import TrainState as JaxTrainState
from adfmsl.train import make_optimizer as jax_make_optimizer
from adfmsl.train import make_train_step as jax_make_train_step
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model, state_dict_from_flax
from adfmsl_torch.train import Optimizer, TrainState, make_train_step

CUT, BATCH, STEPS_PER_EPOCH = 4000, 4, 10
NAMES = ["maze5", "maze5_fmsl", "maze4", "maze4_fmsl"]
F32_TOL = {"loss": 1e-5, "cos": 0.999, "cos_small": 0.99, "ratio": 0.01,
           "ratio_small": 0.05, "update_cos": 0.99, "update_ratio": 0.02, "stats": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def deterministic(exp, dtype):
    """Randomness off, at the test's cut and dtype; works on both packages'
    configs (the port's is a copy of adfmsl's)."""
    exp.data.cut = CUT
    exp.model.dtype = dtype
    exp.model.architecture.dropout_rate = 0.0
    exp.model.architecture.fc_dropout = 0.0
    exp.model.spec_augment.enabled = False
    if exp.model.fmsl is not None:
        exp.model.fmsl.proj_dropout = 0.0
        exp.model.fmsl.enable_lsa = False
    return exp


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def batch(seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((BATCH, CUT))).astype(np.float32)
    return x, np.array([0, 1, 0, 1], np.int32), np.ones(BATCH, bool)


class JaxRun:
    """adfmsl's model, train state and jitted train step for one config, and
    its gradient of the same loss (``make_train_step``'s ``loss_fn``)."""

    def __init__(self, name, dtype, configure=None):
        from adfmsl.heads.losses import compute_loss

        exp = deterministic(jax_experiment(name), dtype)
        if configure:
            configure(exp)
        self.exp, self.name = exp, name
        self.model = jax_build_model(exp.model)
        x0 = jnp.zeros((BATCH, CUT), jnp.float32)
        v = jax.jit(lambda k, x: self.model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), x0)
        self.params, self.stats = v["params"], v["batch_stats"]
        tx, _ = jax_make_optimizer(exp, STEPS_PER_EPOCH)
        self.state = JaxTrainState.create(apply_fn=self.model.apply, params=self.params,
                                          batch_stats=self.stats, tx=tx)
        self.step = jax_make_train_step(exp, donate=False)
        lcfg = exp.train.loss

        def loss_fn(params, stats, x, labels, mask):
            out, _ = self.model.apply({"params": params, "batch_stats": stats}, x,
                                      labels=labels, train=True, mask=mask,
                                      mutable=["batch_stats"])
            if "loss" in out:
                return out["loss"]
            return compute_loss(lcfg.name, out["logits"], labels,
                                class_weights=lcfg.class_weights,
                                focal_alpha=lcfg.focal_alpha,
                                focal_gamma=lcfg.focal_gamma, mask=mask)
        self.grad = jax.jit(jax.value_and_grad(loss_fn))

    def to_port(self, params, stats):
        return state_dict_from_flax(_np(params), _np(stats), self.name)


_RUNS = {}


def jax_run(name, dtype):
    """adfmsl's run of a standardized config, built once per module (each
    build compiles adfmsl's init, gradient and step)."""
    if (name, dtype) not in _RUNS:
        _RUNS[name, dtype] = JaxRun(name, dtype)
    return _RUNS[name, dtype]


def port_state(jr, dtype, configure=None):
    exp = deterministic(make_experiment(jr.name), dtype)
    if configure:
        configure(exp)
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(jr.to_port(jr.params, jr.stats), strict=True)
    opt = Optimizer(exp.train.optimizer, model.parameters(), STEPS_PER_EPOCH,
                    exp.train.num_epochs)
    return exp, TrainState(model, opt, seed=0)


def port_grads(state, metrics):
    """The step's unclipped gradients by name: ``.grad`` holds them clipped by
    min(1, clip / norm)."""
    clip = state.optimizer.clip
    norm = float(metrics["grad_norm"])
    factor = clip / norm if clip and norm >= clip else 1.0
    return {n: p.grad.detach().float().numpy() / factor
            for n, p in state.model.named_parameters()}


def compare_grads(got, ref, tol):
    gnorm = np.sqrt(sum(float((v.ravel() @ v.ravel())) for v in ref.values()))
    checked = 0
    for key, r in ref.items():
        a, b = got[key].ravel(), r.ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 3e-5 * gnorm and nb < 3e-5 * gnorm:
            continue                     # analytically zero on both sides
        cos = float(a @ b / (na * nb))
        need = tol["cos"] if a.size >= 512 else tol["cos_small"]
        assert cos >= need, f"{key}: gradient cosine {cos:.6f} < {need}"
        rtol = tol["ratio"] if nb >= 0.01 * gnorm else tol["ratio_small"]
        assert abs(na / nb - 1.0) <= rtol, f"{key}: |grad| ratio {na / nb:.5f}"
        checked += 1
    assert checked >= 20, f"only {checked} gradient leaves compared"


def compare_updates(port_pre, port_post, ref_pre, ref_post, tol):
    dot = nt = nj = 0.0
    for key, r in ref_pre.items():
        if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        dt = (port_post[key].float() - port_pre[key].float()).numpy().ravel()
        dj = (ref_post[key].float() - r.float()).numpy().ravel()
        dot += float(dt @ dj)
        nt += float(dt @ dt)
        nj += float(dj @ dj)
    cos = dot / np.sqrt(nt * nj)
    print(f"global update cosine {cos:.6f}, |update| ratio {np.sqrt(nt / nj):.6f}")
    assert cos >= tol["update_cos"], f"global update cosine {cos:.6f}"
    assert abs(np.sqrt(nt / nj) - 1.0) <= tol["update_ratio"], \
        f"global |update| ratio {np.sqrt(nt / nj):.5f}"


def compare_stats(port_sd, ref_sd, tol):
    n = 0
    for key, r in ref_sd.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(port_sd[key].numpy(), r.numpy(), rtol=0,
                                       atol=tol * max(1.0, float(r.abs().max())),
                                       err_msg=key)
            n += 1
    assert n >= 20


def one_step(name, dtype, tol, configure=None, seed=0):
    jr = JaxRun(name, dtype, configure) if configure else jax_run(name, dtype)
    x, y, m = batch(seed)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    ref_loss, ref_g = jr.grad(jr.params, jr.stats, jx, jy, jm)
    new, jmet = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))
    exp, st = port_state(jr, dtype, configure)
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    step = make_train_step(exp)
    met = step(st, torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(m))
    loss = float(met["loss"])
    assert st.step == 1 and float(met["skipped"]) == 0.0
    np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=tol["loss"])
    np.testing.assert_allclose(loss, float(ref_loss), rtol=tol["loss"])
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=tol["ratio"])
    ref_grads = {k: v.numpy() for k, v in jr.to_port(ref_g, jr.stats).items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    compare_grads(port_grads(st, met), ref_grads, tol)
    ref_pre = jr.to_port(jr.params, jr.stats)
    ref_post = jr.to_port(new.params, new.batch_stats)
    post = st.model.state_dict()
    compare_updates(pre, post, ref_pre, ref_post, tol)
    compare_stats(post, ref_post, tol["stats"])
    return jr, st, step


@pytest.mark.parametrize("name", NAMES)
def test_one_step_f32_matches_adfmsl(name):
    one_step(name, "float32", F32_TOL)


def test_three_step_loss_trajectory_maze5_f32():
    """Three steps on three batches: each step's loss within 1e-4 relative of
    adfmsl's, so the updates compound the same way (looser than one step's
    1e-5: each AdamW step moves the noise-level gradient coordinates by a
    coin-flip lr, which shows in the next loss at about 2e-5)."""
    jr = jax_run("maze5", "float32")
    exp, st = port_state(jr, "float32")
    step = make_train_step(exp)
    state = jr.state
    for i in range(3):
        x, y, m = batch(10 + i)
        state, jmet = jr.step(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                              jax.random.PRNGKey(i))
        met = step(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                   torch.from_numpy(m))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert st.step == 3 and st.optimizer.count == 3 and int(state.step) == 3


def test_nonfinite_batch_keeps_state_and_advances_step():
    """A NaN in the batch: adfmsl and the port both keep parameters, BN
    statistics and optimizer state, report the step as skipped with loss 0,
    and advance the step counter."""
    jr = jax_run("maze5", "float32")
    exp, st = port_state(jr, "float32")
    x, y, m = batch(3)
    x[1, 100] = np.nan
    new, jmet = jr.step(jr.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                        jax.random.PRNGKey(0))
    assert float(jmet["skipped"]) == 1.0 and float(jmet["loss"]) == 0.0
    assert int(new.step) == 1
    for a, b in zip(jax.tree.leaves((new.params, new.batch_stats)),
                    jax.tree.leaves((jr.params, jr.stats))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    assert float(met["skipped"]) == 1.0 and float(met["loss"]) == 0.0
    assert st.step == 1 and st.optimizer.count == 0 and not st.optimizer.opt.state
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, pre[k]), k


def test_clip_engages_like_optax():
    """SGD (no decay) with a clip far below the gradient norm: the gradients
    are scaled to norm ``clip`` (within 1e-5), and the update, as adfmsl's
    chain gives it, is lr * clip in norm (within 1e-3: each element of the
    f32 parameter delta carries the rounding of a parameter 1e3 times its
    size)."""
    def configure(exp):
        o = exp.train.optimizer
        o.name, o.lr, o.momentum, o.weight_decay, o.grad_clip_norm = "sgd", 0.1, 0.9, 0.0, 1e-3

    jr, st, _ = one_step("maze5", "float32", F32_TOL, configure, seed=5)
    assert st.optimizer.clip == 1e-3
    clipped = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in st.model.parameters()))
    np.testing.assert_allclose(clipped, 1e-3, rtol=1e-5)
    pre = jr.to_port(jr.params, jr.stats)
    delta = np.sqrt(sum(float(((p.detach().double() - pre[n].double()) ** 2).sum())
                        for n, p in st.model.named_parameters()))
    np.testing.assert_allclose(delta, 0.1 * 1e-3, rtol=1e-3)


def test_step_parts_are_labelled_for_the_profiler():
    """The real step runs its forward, backward and update under the labels
    that the benchmark's ``train_fwd_ms`` / ``train_bwd_ms`` readers read its
    device-time split from: each label once per step, and the forward's range
    holds the model's convolutions."""
    from torch.profiler import ProfilerActivity, profile

    from adfmsl_torch.train.steps import STEP_LABELS

    exp = deterministic(make_experiment("maze5"), "float32")
    model = build_model(exp.model, device="cpu", seed=0)
    st = TrainState(model, Optimizer(exp.train.optimizer, model.parameters(),
                                     STEPS_PER_EPOCH, exp.train.num_epochs), seed=0)
    x, y, m = batch(7)
    step = make_train_step(exp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(st, torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(m))
    counts = {e.key: e.count for e in prof.key_averages() if e.key in STEP_LABELS}
    assert counts == {k: 2 for k in STEP_LABELS}
    fwd = next(e for e in prof.events() if e.name == STEP_LABELS[0])
    names = set()
    stack = list(fwd.cpu_children)
    while stack:
        e = stack.pop()
        names.add(e.name)
        stack += e.cpu_children
    assert "aten::convolution" in names
