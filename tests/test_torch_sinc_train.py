"""K3's trainable wrapper in the port (``adfmsl_torch.ops.sinc_fused.
sinc_abs_pool``, a ``torch.autograd.Function``) vs adfmsl's custom VJP
(``adfmsl/ops/pallas/sinc_fused.py:sinc_abs_pool``, the Pallas kernel in
interpret mode on the CPU), at full width (C 128, K 251) on (2, 8000) and the
ragged (3, 8001).

Tolerances:
- forward within 1e-3 * max|ref|, K3's own tolerance: on the CPU the port's
  forward is the plain version, which rounds the operands to bf16 as the
  kernel does;
- backward with the same seeded cotangent on both sides (``jax.vjp`` against
  ``torch.autograd.grad``): d filters and d x within 1e-4 * max|ref|. Both
  sides take the VJP of the f32 composition at the same unrounded operands,
  so only the order of f32 sums differs;
- the gradient reaching the sinc cutoffs ``low_hz`` / ``band_hz`` through
  ``sinc_filters`` within 1e-4 * max|ref| of ``jax.grad`` with respect to
  ``low`` / ``band``.

Then ``SincConv``'s dispatch (adfmsl ``models/sincnet.py:82-92``), and on the
card (marker ``cuda``) the Function (d filters from the backward kernel at
'3xtf32') against autograd through the composition with TF32 off, the
cotangent zeroed at near-tie triples on both sides (``sinc_fused.
near_tie_mask``):
    python -m pytest --noconftest -q tests/test_torch_sinc_train.py -m cuda
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.models import sincnet as port_sincnet
from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.ops import sinc_fused as sf
from adfmsl_torch.ops.sinc import sinc_abs_pool3_nhc, sinc_filters, sinc_init

SHAPES = [(2, 8000), (3, 8001)]        # T' % 3 == 1 and == 2; both ragged tiles
IDS = ["jax_case", "ragged"]
C, K = 128, 251


def _cutoffs():
    low, band = sinc_init(C)
    return low, band


def _filters():
    low, band = _cutoffs()
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), K)


def _x(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _cotangent(shape, seed):
    t3 = (shape[1] - K + 1) // 3
    return np.random.default_rng(seed).standard_normal((shape[0], t3, C)).astype(np.float32)


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_and_vjp_match_adfmsl(shape):
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.pallas.sinc_fused import sinc_abs_pool as jax_sap

    f = _filters()
    x = _x(shape, seed=1)
    g = _cotangent(shape, seed=2)
    ref, vjp = jax.vjp(lambda a, b: jax_sap(a, b, True), jnp.asarray(x),
                       jnp.asarray(f.numpy()))
    ref_dx, ref_df = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    ft = f.clone().requires_grad_(True)
    y = sf.sinc_abs_pool(xt, ft)
    assert y.dtype == torch.float32
    _close(y, ref, 1e-3, "forward")
    assert torch.equal(y.detach(), sf.sinc_abs_pool_plain(xt.detach(), f))
    dx, df = torch.autograd.grad(y, (xt, ft), torch.from_numpy(g))
    _close(df, ref_df, 1e-4, "d filters")
    _close(dx, ref_dx, 1e-4, "d x")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gradients_reach_the_cutoffs_like_adfmsl(shape):
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.pallas.sinc_fused import sinc_abs_pool as jax_sap
    from adfmsl.ops.sinc import sinc_filters as jax_filters

    low, band = _cutoffs()
    x = _x(shape, seed=3)
    g = _cotangent(shape, seed=4)

    def loss(lo, ba):
        return jnp.sum(jnp.asarray(g) * jax_sap(jnp.asarray(x), jax_filters(lo, ba, K), True))

    ref_low, ref_band = jax.grad(loss, argnums=(0, 1))(jnp.asarray(low), jnp.asarray(band))
    lo = torch.from_numpy(low).requires_grad_(True)
    ba = torch.from_numpy(band).requires_grad_(True)
    y = sf.sinc_abs_pool(torch.from_numpy(x), sinc_filters(lo, ba, K))
    (torch.from_numpy(g) * y).sum().backward()
    _close(lo.grad, ref_low, 1e-4, "low_hz")
    _close(ba.grad, ref_band, 1e-4, "band_hz")


def test_backward_asks_only_for_the_gradients_needed():
    """A waveform that requires no gradient gets none, as in a train step;
    the filters' gradient is the composition's."""
    f = _filters().requires_grad_(True)
    x = torch.from_numpy(_x((1, 1500), seed=5))
    g = torch.from_numpy(_cotangent((1, 1500), seed=6))
    (df,) = torch.autograd.grad(sf.sinc_abs_pool(x, f), (f,), g)
    (want,) = torch.autograd.grad(sinc_abs_pool3_nhc(x, f), (f,), g)
    torch.testing.assert_close(df, want, rtol=0, atol=0)
    xr = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(sf.sinc_abs_pool(xr, f.detach()), (xr,), g)
    assert dx.shape == x.shape and torch.isfinite(dx).all()


def test_sinc_conv_train_dispatch(monkeypatch):
    """adfmsl's rule: in train mode with fused_train the front end runs the
    Function up to fused_max_batch rows (16) and the f32 composition above
    it; without fused_train it always runs the composition; at eval the
    fused_eval rule holds as before."""
    calls = []

    def counted(*args):
        calls.append(args[0].shape[0])
        return sf.sinc_abs_pool(*args)
    monkeypatch.setattr(port_sincnet, "sinc_abs_pool", counted)
    fused = SincConv(post="abs_pool3", fused_train=True).train()
    plain = SincConv(post="abs_pool3").train()
    small = torch.from_numpy(_x((16, 1200), seed=7))
    big = torch.from_numpy(_x((17, 1200), seed=8))
    f = fused.filters().detach()
    got = fused(small)
    assert calls == [16] and got.requires_grad
    assert torch.equal(got.detach(), sf.sinc_abs_pool_plain(small, f))
    assert torch.equal(fused(big).detach(), sinc_abs_pool3_nhc(big, f))
    assert torch.equal(plain(small).detach(), sinc_abs_pool3_nhc(small, f))
    assert calls == [16]
    with torch.inference_mode():
        fused.eval()
        assert torch.equal(fused(small), sinc_abs_pool3_nhc(small, f))   # fused_eval off
        both = SincConv(post="abs_pool3", fused_eval=True, fused_train=True).eval()
        assert torch.equal(both(small), sf.sinc_abs_pool_fused(small, f))
    assert calls == [16]
    fused.train()
    fused(small).sum().backward()
    assert fused.low_hz.grad is not None and fused.band_hz.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8000), (12, 64600)], ids=["jax_case", "b12_cut64600"])
def test_function_matches_composition_autograd_on_card(shape, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K3 kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    f = _filters().cuda().requires_grad_(True)
    x = torch.from_numpy(_x(shape, seed=9)).cuda()
    g = torch.from_numpy(_cotangent(shape, seed=10)).cuda()
    # near-ties route by the order of f32 sums (tests/test_torch_sinc_bwd.py)
    near = sf.near_tie_mask(x, f.detach(), "3xtf32")
    g = torch.where(near, 0.0, g)
    print(f"{int(near.sum())} near-tie triples of {near.numel()} zeroed on both sides")
    before = sf.sinc_abs_pool_fused.launches
    before_bwd = sf.sinc_abs_pool_bwd.launches
    y = sf.sinc_abs_pool(x, f, True)
    (df,) = torch.autograd.grad(y, (f,), g)
    torch.cuda.synchronize()
    assert sf.sinc_abs_pool_fused.launches == before + 1
    assert sf.sinc_abs_pool_bwd.launches == before_bwd + 1      # d filters: the kernel
    want_y = sf.sinc_abs_pool_plain(x, f.detach())
    (want_df,) = torch.autograd.grad(sinc_abs_pool3_nhc(x, f), (f,), g)
    _close(y.cpu(), want_y.cpu().numpy(), 1e-3, "forward")
    _close(df.cpu(), want_df.cpu().numpy(), 1e-4, "d filters")
