"""One train step of RawNet main / main_fmsl in the port against adfmsl's
``make_train_step``.

Full width (128 sinc filters, K=251, blocks 128->128->128->256->256->256->256,
GRU 1024, fc1_gru 1024, FMSL 'replace' at 1024), cut 8000 (the GRU runs 3
steps), batch 4, each model with its own loss and optimizer (main: weighted CE
[0.1, 0.9] divided by the summed target weights, Adam with coupled L2, lr
1e-4, wd 1e-4, no clip; main_fmsl: the FMSL head's CE with the angular margin
on the target class, Adam), the randomness off (LSA and projection dropout
off), from adfmsl's init carried across by ``state_dict_from_flax``. Each
step runs with the fused training front end off (the f32 composition) and on
(kernel K3's forward: adfmsl's Pallas kernel in interpret mode, the port's
plain version, both with bf16-rounded operands; the backward recomputes the
f32 composition on both sides). A 2-layer GRU case for main follows
``tests/test_train_parity.py:328-352``.

With the fused front end, adfmsl's kernel is handed the filter values the
port synthesizes (``filters + stop_gradient(port - filters)``: adfmsl's own
derivative, the port's values; every step here starts from the init). The two
packages' ``sinc_filters`` agree to about 2e-6 * max in f32, and rounding the
filters to bf16 turns that into a whole bf16 step (2^-8 relative) on the few
dozen of the 32,128 taps that lie that close to a rounding midpoint: main's
f32 loss then moved by 8e-5 relative. With the same values, the two forwards
differ only in the order of f32 sums of exact bf16 products (4e-7 * max).

Tolerances. f32: those of tests/test_torch_train_step.py (``F32_TOL``), the
fused front end included. bf16: adfmsl's bf16 steps are compiled without
XLA's excess precision, so that they round at every bf16 operation as their
semantics (and the port) do: the CPU backend otherwise keeps the
intermediates of fused elementwise chains in f32, which put adfmsl's
resnet18_logmel gradient 0.015 closer to its f32 gradient than its bf16
semantics allow. Even so, adfmsl's own bf16 step is close to chaotic here.
Multiplying the batch by 1 + 1e-6 N(0, 1), a change of f32-noise size, moved
its loss by up to 3 % (main) and its global gradient cosine to its f32
gradient between 0.81 and 0.89 (main_fmsl) over six draws: the late
BatchNorms take their statistics over few rows (block5 over 4 x 10,
bn_before_gru over 4 x 3 at this cut), and main_fmsl's 'replace' head, at
s = 32, normalises over the 4 rows of the batch (``proj_bn``) as maze4_fmsl's
does (tests/test_torch_train_step_bf16.py). One draw cannot tell two bf16
paths apart, so the checks of tests/test_torch_train_step_bf16.py
(``BF16_TOL``) are held against the envelope of adfmsl's own bf16 step over
``DRAWS`` draws (``check_bf16_envelope``): no draw of the port's falls below
adfmsl's worst by more than BF16_TOL's margin or twice adfmsl's own spread.
main_fmsl's margin is 0.1 instead of 0.02, its global floor 0.75 instead of
0.9 and its gradient norm may stray 20 % from the f32 norm instead of 10 %:
over six draws adfmsl's own global cosine spanned 0.81-0.89 and its norm
strayed by up to 15 % (the port's: 0.78-0.88, 18 %), and four draws do not
pin its worst case down (its per-leaf cosines of fc_attention1 spanned
0.860-0.871 where the port's spanned 0.819-0.853).
Compared: the loss, per-leaf gradients (the GRU's recurrent kernels and the
sinc ``low_hz`` / ``band_hz`` among them), the post-step parameters and the BN
running statistics.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_step import (F32_TOL, JaxRun, compare_grads, compare_stats,
                                   compare_updates, port_grads, port_state)
from test_torch_train_step_bf16 import ANALYTIC_ZERO, BF16_TOL, _cos
from adfmsl_torch.ops import sinc_fused as sf
from adfmsl_torch.train import make_train_step

CUT, BATCH = 8000, 4
NAMES = ["main", "main_fmsl"]
FRONTENDS = {"composition": False, "fused": True}
RAWNET_BF16 = {"main": BF16_TOL,
               "main_fmsl": {**BF16_TOL, "margin": 0.1, "floor": 0.75, "ratio": 0.2}}
DRAWS = 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _adfmsl_kernel_takes_the_ports_filters():
    """adfmsl's fused front end (``ops/pallas/sinc_fused.py:sinc_abs_pool``,
    looked up when its SincConv is traced) gets the port's filter values at
    the init cutoffs, with adfmsl's own derivative (see the docstring)."""
    import adfmsl.ops.pallas.sinc_fused as jax_sinc_fused
    from adfmsl_torch.ops.sinc import sinc_filters, sinc_init

    low, band = sinc_init(128)
    port = jnp.asarray(sinc_filters(torch.from_numpy(low), torch.from_numpy(band),
                                    251).numpy())
    adfmsl_sap = jax_sinc_fused.sinc_abs_pool

    def at_port_values(x, filters, interpret=False):
        return adfmsl_sap(x, filters + jax.lax.stop_gradient(port - filters), interpret)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sinc_fused, "sinc_abs_pool", at_port_values)
    yield
    mp.undo()


def rawnet_batch(seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((BATCH, CUT))).astype(np.float32)
    return x, np.array([0, 1, 0, 1], np.int32), np.ones(BATCH, bool)


def configure(fused, gru_layers=1):
    def apply(exp):
        exp.data.cut = CUT
        exp.model.extra["fused_train_frontend"] = fused
        exp.model.architecture.nb_gru_layer = gru_layers
    return apply


_RUNS = {}
# XLA's CPU backend otherwise keeps the bf16 intermediates of a fused chain of
# elementwise ops in f32 ("excess precision"): adfmsl's bf16 step on the CPU
# would then round less often than its bf16 semantics (and the port) say
STRICT_BF16 = {"xla_allow_excess_precision": False}


def strict_bf16(jr):
    """adfmsl's bf16 run compiled to round at every bf16 op."""
    jr.grad = jax.jit(jr.grad, compiler_options=STRICT_BF16)
    jr.step = jax.jit(jr.step, compiler_options=STRICT_BF16)
    return jr


def jax_run(name, dtype, fused, gru_layers=1):
    """adfmsl's run of a configuration, built once per module."""
    key = (name, dtype, fused, gru_layers)
    if key not in _RUNS:
        jr = JaxRun(name, dtype, configure(fused, gru_layers))
        _RUNS[key] = strict_bf16(jr) if dtype == "bfloat16" else jr
    return _RUNS[key]


def port_step(jr, dtype, fused, gru_layers, x, y, m):
    """The port's state from adfmsl's init, one step; returns (state, metrics,
    the state dict before the step)."""
    exp, st = port_state(jr, dtype, configure(fused, gru_layers))
    assert st.model.encoder.sinc.fused_train is fused
    assert st.model.encoder.gru.layers == gru_layers
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    sf.sinc_abs_pool_fused.launches = 0
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    assert sf.sinc_abs_pool_fused.launches == 0           # the CPU runs the plain version
    assert st.step == 1 and float(met["skipped"]) == 0.0
    return st, met, pre


def f32_step(name, fused, gru_layers=1, seed=0):
    jr = jax_run(name, "float32", fused, gru_layers)
    assert jr.exp.train.optimizer.name == "adam"
    assert jr.exp.train.optimizer.grad_clip_norm == 0.0
    x, y, m = rawnet_batch(seed)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    ref_loss, ref_g = jr.grad(jr.params, jr.stats, jx, jy, jm)
    new, jmet = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))
    st, met, pre = port_step(jr, "float32", fused, gru_layers, x, y, m)
    tol = F32_TOL
    loss = float(met["loss"])
    np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=tol["loss"])
    np.testing.assert_allclose(loss, float(ref_loss), rtol=tol["loss"])
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=tol["ratio"])
    ref_grads = {k: v.numpy() for k, v in jr.to_port(ref_g, jr.stats).items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    got = port_grads(st, met)
    compare_grads(got, ref_grads, tol)
    for k in ("encoder.sinc.low_hz", "encoder.sinc.band_hz", "encoder.gru.cell.hr.weight",
              "encoder.gru.cell.hn.weight"):
        assert np.linalg.norm(ref_grads[k]) > 0, k                   # compared above
    post = st.model.state_dict()
    ref_post = jr.to_port(new.params, new.batch_stats)
    compare_updates(pre, post, jr.to_port(jr.params, jr.stats), ref_post, tol)
    compare_stats(post, ref_post, tol["stats"])
    return jr, st


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", NAMES)
def test_one_step_f32_matches_adfmsl(name, frontend):
    f32_step(name, FRONTENDS[frontend])


def test_two_layer_gru_step_f32_matches_adfmsl():
    """main with ``nb_gru_layer`` 2 (the reference YAML stacks 3): the first
    layer hands its 3-step sequence to the second; both layers' gates
    (``cell``, ``cell1``) are compared."""
    jr, st = f32_step("main", False, gru_layers=2, seed=1)
    names = dict(st.model.named_parameters())
    assert "encoder.gru.cell1.hz.weight" in names
    assert tuple(names["encoder.gru.cell1.ir.weight"].shape) == (1024, 1024)


def bf16_draws(j32, j16, run_port, batch, skip=ANALYTIC_ZERO):
    """Per copy of ``batch`` (``DRAWS`` of them: the batch itself, then the
    batch times 1 + 1e-6 N(0, 1)): the loss, gradient, update and post-step
    statistics of adfmsl's f32 (``j32``) and bf16 (``j16``) steps and of the
    port's bf16 step (``run_port(x, y, m) -> (state, metrics, pre)``), each
    from adfmsl's init. Returns ({'f32' | 'adfmsl' | 'port': [per draw]},
    the compared parameter names: all but those ending in ``skip``)."""
    x0, y, m = batch

    def numpy_sd(sd):
        return {k: v.numpy().astype(np.float64) for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
    ref_pre = numpy_sd(j16.to_port(j16.params, j16.stats))
    out = {"f32": [], "adfmsl": [], "port": []}
    for d in range(DRAWS):
        x = x0 if d == 0 else (x0 * (1.0 + 1e-6 * np.random.default_rng(100 + d)
                                     .standard_normal(x0.shape))).astype(np.float32)
        jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
        for tag, jr in (("f32", j32), ("adfmsl", j16)):
            loss, g = jr.grad(jr.params, jr.stats, jx, jy, jm)
            new, _ = jr.step(jr.state, jx, jy, jm, jax.random.PRNGKey(1))
            post = numpy_sd(jr.to_port(new.params, new.batch_stats))
            out[tag].append({"loss": float(loss), "grad": numpy_sd(jr.to_port(g, jr.stats)),
                             "update": {k: post[k] - ref_pre[k] for k in post},
                             "post": post})
        st, met, _ = run_port(x, y, m)
        post = numpy_sd(st.model.state_dict())
        out["port"].append({"loss": float(met["loss"]), "grad": port_grads(st, met),
                            "update": {k: post[k] - ref_pre[k] for k in post},
                            "post": post})
    keys = [k for k, _ in st.model.named_parameters() if not (skip and k.endswith(skip))]
    return out, keys


def check_bf16_envelope(runs, keys, tol, label, min_leaves=10, min_stats=20):
    """The checks of tests/test_torch_train_step_bf16.py against the envelope
    of adfmsl's own bf16 step over the draws of ``bf16_draws``. On every draw
    the port's loss, gradient cosines to the f32 gradient (global, and per
    leaf of 1 % of the norm or more), update cosine to the f32 update and BN
    statistics are no further from adfmsl's f32 step than adfmsl's bf16 step
    is on its worst draw, by a margin: ``tol``'s (1e-2 relative for the loss,
    ``margin`` for the cosines, ``stats``), or twice the width of adfmsl's own
    spread over the draws where that is wider: with four draws, a gap within
    it does not tell two bf16 paths apart. The gradient's norm stays within
    ``tol['ratio']`` of the f32 norm and the update's within
    ``tol['update_ratio']`` of adfmsl's bf16 update."""
    f32, own, port = runs["f32"], runs["adfmsl"], runs["port"]

    def flat(tree, k=None):
        return np.ravel(tree[k]) if k else np.concatenate([np.ravel(tree[k]) for k in keys])

    def cosines(side, what, k=None):
        return [_cos(flat(a[what], k), flat(r[what], k)) for a, r in zip(side, f32)]

    def at_least(port_values, own_values, margin):
        slack = max(margin, 2.0 * (max(own_values) - min(own_values)))
        return min(port_values) >= min(own_values) - slack

    dev_port = [abs(p["loss"] - r["loss"]) for p, r in zip(port, f32)]
    dev_own = [abs(j["loss"] - r["loss"]) for j, r in zip(own, f32)]
    print(f"{label}: loss f32 {f32[0]['loss']:.6f}, distance of adfmsl bf16 "
          f"{np.round(dev_own, 5)}, of the port {np.round(dev_port, 5)}")
    assert at_least([-d for d in dev_port], [-d for d in dev_own],
                    tol["loss"] * abs(f32[0]["loss"])), (dev_port, dev_own)

    port_cos, own_cos = cosines(port, "grad"), cosines(own, "grad")
    print(f"{label}: global gradient cosine to f32: port {np.round(port_cos, 4)}, "
          f"adfmsl {np.round(own_cos, 4)}")
    assert at_least(port_cos, own_cos, tol["margin"]) and min(port_cos) >= tol["floor"]
    ratios = [np.linalg.norm(flat(p["grad"])) / np.linalg.norm(flat(r["grad"]))
              for p, r in zip(port, f32)]
    assert max(abs(r - 1.0) for r in ratios) <= tol["ratio"], ratios
    gnorm = np.linalg.norm(flat(f32[0]["grad"]))
    checked = 0
    for k in keys:
        if np.linalg.norm(flat(f32[0]["grad"], k)) < 0.01 * gnorm:
            continue
        pc, jc = cosines(port, "grad", k), cosines(own, "grad", k)
        assert min(pc) >= tol["leaf_floor"] or at_least(pc, jc, tol["margin"]), (k, pc, jc)
        checked += 1
    assert checked >= min_leaves

    up_port, up_own = cosines(port, "update"), cosines(own, "update")
    print(f"{label}: update cosine to f32: port {np.round(up_port, 4)}, "
          f"adfmsl {np.round(up_own, 4)}")
    assert at_least(up_port, up_own, tol["margin"])
    for p, j in zip(port, own):
        ratio = np.linalg.norm(flat(p["update"])) / np.linalg.norm(flat(j["update"]))
        assert abs(ratio - 1.0) <= tol["update_ratio"], ratio
    n = 0
    for k, v in f32[0]["post"].items():
        if k.endswith(("running_mean", "running_var")):
            err = [np.abs(p["post"][k] - r["post"][k]).max() for p, r in zip(port, f32)]
            own_err = [np.abs(j["post"][k] - r["post"][k]).max() for j, r in zip(own, f32)]
            assert at_least([-e for e in err], [-e for e in own_err],
                            tol["stats"] * max(1.0, np.abs(v).max())), (k, err, own_err)
            n += 1
    assert n >= min_stats


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", NAMES)
def test_one_step_bf16_matches_adfmsl(name, frontend):
    """The bf16 checks of tests/test_torch_train_step_bf16.py, held against
    the envelope adfmsl's own bf16 step spans over ``DRAWS`` copies of the
    batch (``check_bf16_envelope``; see the docstring)."""
    fused = FRONTENDS[frontend]
    j32, j16 = jax_run(name, "float32", fused), jax_run(name, "bfloat16", fused)
    runs, keys = bf16_draws(j32, j16, lambda x, y, m: port_step(j16, "bfloat16", fused, 1,
                                                               x, y, m),
                            rawnet_batch(0))
    check_bf16_envelope(runs, keys, RAWNET_BF16[name], f"{name} {frontend}")


def test_nonfinite_batch_keeps_rawnet_state():
    """A NaN in the batch: adfmsl and the port both keep parameters, BN
    statistics and optimizer state, report the step as skipped with loss 0,
    and advance the step counter."""
    jr = jax_run("main", "float32", False)
    exp, st = port_state(jr, "float32", configure(False))
    x, y, m = rawnet_batch(3)
    x[2, 500] = np.nan
    new, jmet = jr.step(jr.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                        jax.random.PRNGKey(0))
    assert float(jmet["skipped"]) == 1.0 and float(jmet["loss"]) == 0.0
    assert int(new.step) == 1
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    assert float(met["skipped"]) == 1.0 and float(met["loss"]) == 0.0
    assert st.step == 1 and st.optimizer.count == 0 and not st.optimizer.opt.state
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, pre[k]), k


def test_main_fmsl_lsa_draws_from_its_generator():
    """With LSA switched on (the configuration has it off), main_fmsl's train
    loss is finite and its noise comes from the generators it is given: the
    same seeds give the same loss, others another loss."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    exp = make_experiment("main_fmsl")
    exp.model.dtype = "float32"
    exp.model.fmsl.enable_lsa = True
    assert exp.model.fmsl.mode == "replace"
    model = build_model(exp.model, device="cpu", seed=0).train()
    x, y, m = (torch.from_numpy(a) for a in rawnet_batch(4))
    stats = {k: v.clone() for k, v in model.named_buffers()}

    def loss(seed):
        model.load_state_dict({**model.state_dict(), **stats})
        gens = {k: torch.Generator().manual_seed(seed) for k in ("dropout", "lsa")}
        return float(model(x, labels=y.long(), mask=m, rngs=gens)["loss"])

    a, b, c = loss(1), loss(1), loss(2)
    assert np.isfinite(a) and a == b and a != c


@pytest.mark.parametrize("layers", [2, 3])
def test_stacked_gru_matches_adfmsl(layers):
    """The stacked GRU alone at f32, forward and gradients: adfmsl's hoisted
    scans (every layer but the last returning its sequence) vs the port's
    loops, through ``state_dict_from_flax``'s ``cell{k}`` names."""
    from adfmsl.models.blocks import GRU as JaxGRU

    from adfmsl_torch.models.blocks import GRU
    from adfmsl_torch.models.port import state_dict_from_flax

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    g = rng.standard_normal((3, 16)).astype(np.float32)
    jgru = JaxGRU(16, layers=layers, return_sequences=False)
    p = jax.tree.map(np.asarray, jgru.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    assert sorted(p) == ["cell"] + [f"cell{k}" for k in range(1, layers)]
    for cell in p.values():
        for gate in ("ir", "iz", "in", "hn"):                  # non-zero biases
            cell[gate]["bias"] = rng.standard_normal(16).astype(np.float32)
    ref, vjp = jax.vjp(lambda pp, xx: jgru.apply({"params": pp}, xx), p, jnp.asarray(x))
    ref_gp, ref_gx = vjp(jnp.asarray(g))
    gru = GRU(32, 16, layers=layers)
    sd = state_dict_from_flax({"gru": p}, {}, "main")
    gru.load_state_dict({k[len("gru."):]: t for k, t in sd.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = gru(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), rtol=0, atol=1e-5)
    ref_sd = state_dict_from_flax({"gru": jax.tree.map(np.asarray, ref_gp)}, {}, "main")
    for k, want in ref_sd.items():
        have = dict(gru.named_parameters())[k[len("gru."):]].grad
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(want.abs().max())), err_msg=k)


def test_state_dict_covers_a_two_layer_gru():
    """main with a 2-layer GRU: every flax leaf crosses (the second layer's
    gates as ``encoder.gru.cell1``), and the port's model loads it strictly."""
    jr = jax_run("main", "float32", False, gru_layers=2)
    p = jax.tree.map(np.asarray, jr.params)
    assert len(jax.tree.leaves(p)) == 80 + 10                   # one more cell
    sd = jr.to_port(jr.params, jr.stats)
    cell1 = p["encoder"]["gru"]["cell1"]
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        np.testing.assert_array_equal(sd[f"encoder.gru.cell1.{gate}.weight"].numpy(),
                                      cell1[gate]["kernel"].T)
        assert (f"encoder.gru.cell1.{gate}.bias" in sd) == (gate not in ("hr", "hz"))
    assert tuple(sd["encoder.gru.cell1.ir.weight"].shape) == (1024, 1024)
    _, st = port_state(jr, "float32", configure(False, 2))     # load_state_dict(strict=True)
    assert st.model.encoder.gru.layers == 2
