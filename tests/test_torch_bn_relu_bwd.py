"""K2 (train-mode BN + ReLU with the two-pass backward) in the port vs adfmsl.

The port's ``bn_relu_train`` on the CPU (its backward is the plain version,
``bn_relu_bwd_plain``) is held against adfmsl's ``bn_relu_train`` with the
Pallas backward in interpret mode, on test_pallas.py:199's case at f32 and on
a bf16 case of two 2048-row tiles with a ragged tail: y, dx, dgamma, dbeta.
Tolerances: f32 within 1e-5 relative (atol 1e-5 * max|ref|); bf16 y and dx
within one bf16 ulp of |ref| plus 1e-3 * max|ref|, dgamma / dbeta (f32 sums
of the same bf16 inputs) within 1e-4 * max|ref|. The same function is held
against torch autograd of the plain forward, and the CUDA kernel against the
plain version on the card (marker ``cuda``):
    python -m pytest --noconftest -q tests/test_torch_bn_relu_bwd.py -m cuda
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.ops import bn_relu_bwd as k2

CASES = [((2, 700, 128), "float32", 17),     # test_pallas.py:199: B*T not a tile multiple
         ((3, 1000, 128), "bfloat16", 5)]     # two 2048-row tiles, ragged tail
IDS = ["jax_case_f32", "two_tiles_bf16"]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    tct = torch.from_numpy(ct).to(_TORCH[dtype])
    return tx, torch.from_numpy(gamma), torch.from_numpy(beta), tct


def _port(x, gamma, beta, ct):
    x = x.clone().requires_grad_(True)
    g = gamma.clone().requires_grad_(True)
    b = beta.clone().requires_grad_(True)
    y = k2.bn_relu_train(x, g, b, 1e-5)
    dx, dg, db = torch.autograd.grad(y, (x, g, b), ct)
    return [t.detach().float().numpy() for t in (y, dx, dg, db)]


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 bits of mantissa)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _close(got, ref, dtype, what):
    scale = float(np.abs(ref).max())
    if dtype == "float32" or what in ("dgamma", "dbeta"):
        tol = 1e-5 if dtype == "float32" else 1e-4
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale, err_msg=what)
    else:
        err = np.abs(got - ref)
        bound = _bf16_ulp(ref) + 1e-3 * scale
        assert (err <= bound).all(), f"{what}: max excess {(err - bound).max()}"


@pytest.mark.parametrize("shape,dtype,seed", CASES, ids=IDS)
def test_matches_adfmsl_pallas_interpret(shape, dtype, seed):
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.pallas.bn_relu_bwd import bn_relu_train as jax_bn_relu_train

    x, gamma, beta, ct = _inputs(shape, dtype, seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    jct = jnp.asarray(ct.float().numpy()).astype(jdt)
    y_ref, vjp = jax.vjp(lambda a, g, b: jax_bn_relu_train(a, g, b, 1e-5, True),
                         jx, jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()))
    refs = [np.asarray(y_ref, np.float32)] + [np.asarray(r, np.float32) for r in vjp(jct)]
    got = _port(x, gamma, beta, ct)
    assert got[1].shape == shape and got[2].shape == (shape[-1],)
    for g, r, what in zip(got, refs, ("y", "dx", "dgamma", "dbeta")):
        _close(g, r, dtype, what)


@pytest.mark.parametrize("shape,dtype,seed", CASES, ids=IDS)
def test_matches_torch_autograd_of_the_plain_forward(shape, dtype, seed):
    """The two-pass formula against autograd through the forward's own
    math, in f32 (the bf16 case's inputs widened), at the f32 tolerance."""
    x, gamma, beta, ct = _inputs(shape, dtype, seed)
    xf, ctf = x.float(), ct.float()
    xa = xf.clone().requires_grad_(True)
    ga = gamma.clone().requires_grad_(True)
    ba = beta.clone().requires_grad_(True)
    y, _, _ = k2.bn_relu_forward(xa, ga, ba)
    refs = [y.detach().numpy()] + [t.numpy() for t in
                                   torch.autograd.grad(y, (xa, ga, ba), ctf)]
    got = _port(xf, gamma, beta, ctf)
    for g, r, what in zip(got, refs, ("y", "dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=what)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    x, gamma, beta, ct = _inputs((1, 40, 128), "bfloat16", 3)
    _, mu, rstd = k2.bn_relu_forward(x, gamma, beta)
    before = k2.bn_relu_bwd.launches
    got = k2.bn_relu_bwd(x, ct, gamma, beta, mu, rstd)
    want = k2.bn_relu_bwd_plain(x, ct, gamma, beta, mu, rstd)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert k2.bn_relu_bwd.launches == before            # no kernel ran
    with pytest.raises(ValueError):
        k2.bn_relu_bwd(x.to("meta"), ct, gamma, beta, mu, rstd)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,seed", CASES + [((12, 4022, 256), "bfloat16", 9)],
                         ids=IDS + ["maze5_block4_bf16"])
def test_kernel_matches_plain_on_card(shape, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K2 kernel has no CPU form")
    x, gamma, beta, ct = (t.cuda() for t in _inputs(shape, dtype, seed))
    _, mu, rstd = k2.bn_relu_forward(x, gamma, beta)
    want = [t.float().cpu().numpy() for t in k2.bn_relu_bwd_plain(x, ct, gamma, beta, mu, rstd)]
    before = k2.bn_relu_bwd.launches
    got = k2.bn_relu_bwd(x, ct, gamma, beta, mu, rstd)
    torch.cuda.synchronize()
    assert k2.bn_relu_bwd.launches == before + 2
    got = [t.float().cpu().numpy() for t in got]
    for g, r, what in zip(got, want, ("dx", "dgamma", "dbeta")):
        _close(g, r, dtype, what)


def test_entry_point_needs_the_card(monkeypatch):
    from adfmsl_torch import measure_bn_relu_bwd as mb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.run("b16")
    monkeypatch.setattr(mb, "resolve_device", lambda device: torch.device("cpu"))
    with pytest.raises(ValueError, match="b16, b128 or both"):
        mb.run("b1")


@pytest.mark.cuda
def test_entry_point_launches_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K2 kernel has no CPU form")
    from adfmsl_torch import measure_bn_relu_bwd as mb

    before = k2.bn_relu_bwd.launches
    res = mb.measure(2, 3000, 128, torch.device("cuda"), iters=2)
    assert set(res) == {"A_plain", "B_kernel", "A_plain_conv", "B_kernel_conv"}
    assert k2.bn_relu_bwd.launches - before == 2 * (2 + 2) * 2   # 2 programs, 4 backwards
