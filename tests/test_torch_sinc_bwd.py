"""The filters' gradient of K3's trainable form: the port's plain version
(``adfmsl_torch.ops.sinc_fused.sinc_abs_pool_bwd_plain``) against autograd
through the f32 composition and against adfmsl's ``jax.vjp`` of
``sinc_abs_pool`` (the Pallas forward in interpret mode, the XLA recompute's
VJP), at full width (C 128, K 251) on (2, 8000) and the ragged (3, 8001), and
on an exact-tie case; the kernel's filter layouts; the wrapper's checks and its
dispatch. Tolerance against adfmsl: d filters within 1e-4 * max|ref|, since
both sides recompute the same f32 composition and route by its maxima, so only
the order of the f32 sums differs.

On the card (marker ``cuda``) the backward kernel is held against the plain
version at both precisions, with the near-tie rule of
``sinc_fused.near_tie_mask``: where the top two |z| of a pool triple lie closer
than twice the recompute's worst-case error (2^-8 * sum|x||f| for TF32, whose
operands round at 2^-11; 2^-15 for three TF32 passes, an f32 sum of up to 256
terms), two correct recomputes may route differently, so the cotangent is
zeroed there on both sides and the count printed. d filters must then agree
within 2e-3 * max (TF32: its products round at 2^-11) or 1e-4 * max (3xTF32):
    python -m pytest --noconftest -q tests/test_torch_sinc_bwd.py -m cuda -s
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.ops import sinc_fused as sf
from adfmsl_torch.ops.sinc import abs_jax, sinc_abs_pool3_nhc, sinc_filters, sinc_init

C, K = 128, 251
SHAPES = [(2, 8000), (3, 8001)]        # T' % 3 == 1 and == 2; both ragged tiles
IDS = ["jax_case", "ragged"]
CARD_TOL = {"tf32": 2e-3, "3xtf32": 1e-4}


def _filters(c=C, k=K):
    low, band = sinc_init(c)
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k)


def _x(shape, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tie_x(shape, seed=0):
    """Random audio with a constant stretch (whole pool triples of z are equal,
    so the gradient splits three ways) and a silent one (z = 0)."""
    x = _x(shape, seed)
    x[:, 1000:2500] = 0.05
    x[:, 3000:4200] = 0.0
    return x


def _cotangent(shape, seed, c=C, k=K):
    t3 = (shape[1] - k + 1) // 3
    return np.random.default_rng(seed).standard_normal((shape[0], t3, c)).astype(np.float32)


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


def _jax_dfilters(x, f, g):
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.pallas.sinc_fused import sinc_abs_pool as jax_sap

    _, vjp = jax.vjp(lambda b: jax_sap(jnp.asarray(x), b, True), jnp.asarray(f.numpy()))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _silent_triples(x, f):
    """(B, T3, C): pool triples whose three z are exactly 0."""
    z = torch.nn.functional.conv1d(x[:, None, :], f[:, None, :]).transpose(1, 2)
    t3 = z.shape[1] // 3
    return (z[:, : 3 * t3].reshape(x.shape[0], t3, 3, -1) == 0).all(dim=2)


@pytest.mark.parametrize("case", ["jax_case", "ragged", "ties"])
def test_plain_backward_matches_autograd_and_adfmsl(case):
    """Bit for bit autograd's VJP of the composition, the silent triples of
    the ``ties`` case included: both take ``jnp.abs``'s slope +1 at z = 0."""
    shape = (3, 8001) if case == "ragged" else (2, 8000)
    x = torch.from_numpy((_tie_x if case == "ties" else _x)(shape, seed=1))
    g = torch.from_numpy(_cotangent(shape, seed=2))
    f = _filters()
    got = sf.sinc_abs_pool_bwd_plain(x, f, g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, K)
    _close(got, _jax_dfilters(x.numpy(), f, g.numpy()), 1e-4, "d filters vs adfmsl")
    assert bool(_silent_triples(x, f).any()) == (case == "ties")
    fr = f.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(sinc_abs_pool3_nhc(x, fr), (fr,), g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_composition_autograd_matches_adfmsl_vjp_at_silence():
    """Autograd through the port's ``sinc_abs_pool3_nhc`` against adfmsl's
    ``jax.vjp`` of its ``sinc_abs_pool3_nhc`` (adfmsl/ops/sinc.py:293) on
    audio with silent stretches, no cotangent zeroed: d filters and d x within
    1e-4 * max (the same f32 composition on both sides, only the order of the
    f32 sums differs)."""
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.sinc import sinc_abs_pool3_nhc as jax_sap3

    shape = (2, 8000)
    x = _tie_x(shape, seed=13)
    g = _cotangent(shape, seed=14)
    f = _filters()
    assert bool(_silent_triples(torch.from_numpy(x), f).any())
    xr = torch.from_numpy(x).requires_grad_(True)
    fr = f.clone().requires_grad_(True)
    dx, df = torch.autograd.grad(sinc_abs_pool3_nhc(xr, fr), (xr, fr), torch.from_numpy(g))
    _, vjp = jax.vjp(jax_sap3, jnp.asarray(x), jnp.asarray(f.numpy()))
    want_dx, want_df = vjp(jnp.asarray(g))
    _close(df, want_df, 1e-4, "d filters vs adfmsl")
    _close(dx, want_dx, 1e-4, "d x vs adfmsl")


def test_sinc_filters_gradient_at_zero_params_matches_adfmsl():
    """``sinc_filters``' gradient with ``low_hz[0] = 0`` and ``band_hz[1] = 0``
    exactly, where ``jnp.abs`` takes slope +1, against ``jax.grad`` of
    adfmsl's ``sinc_filters`` (adfmsl/ops/sinc.py:54) within 1e-5 * max."""
    import jax
    import jax.numpy as jnp

    from adfmsl.ops.sinc import sinc_filters as jax_sinc_filters

    low, band = sinc_init(16)
    low[0], band[1] = 0.0, 0.0
    w = np.random.default_rng(15).standard_normal((16, 129)).astype(np.float32)

    def jax_loss(lo, ba):
        return jnp.sum(jax_sinc_filters(lo, ba, 129) * jnp.asarray(w))

    want_low, want_band = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(low),
                                                           jnp.asarray(band))
    lo = torch.from_numpy(low).requires_grad_(True)
    ba = torch.from_numpy(band).requires_grad_(True)
    (sinc_filters(lo, ba, 129) * torch.from_numpy(w)).sum().backward()
    assert float(np.abs(np.asarray(want_low)[0])) > 0 and float(np.abs(np.asarray(want_band)[1])) > 0
    _close(lo.grad, want_low, 1e-5, "d low_hz vs adfmsl")
    _close(ba.grad, want_band, 1e-5, "d band_hz vs adfmsl")


def test_abs_jax_takes_slope_one_at_both_zeros():
    z = torch.tensor([0.0, -0.0, 1.0, -1.0], requires_grad=True)
    y = abs_jax(z)
    assert torch.equal(y.detach(), torch.tensor([0.0, 0.0, 1.0, 1.0]))
    y.backward(torch.ones(4))
    assert torch.equal(z.grad, torch.tensor([1.0, 1.0, 1.0, -1.0]))


def test_exact_ties_split_evenly_and_zero_takes_slope_one():
    """Over the constant stretch every pool triple of z is bit-equal, so each
    member takes a third of its gradient; over the silent one z = 0 and each
    member takes a third with jnp.abs's slope +1, which reaches d filters where
    a window meets the silence's edge at zero taps of the filters. A cotangent
    that lives only on such triples shows both, against the formula and
    against adfmsl."""
    shape = (2, 8000)
    x = _tie_x(shape, seed=3)
    f = _filters()
    xt = torch.from_numpy(x)
    z = torch.nn.functional.conv1d(xt[:, None, :], f[:, None, :]).transpose(1, 2)
    t3 = z.shape[1] // 3
    zz = z[:, : 3 * t3].reshape(2, t3, 3, C)
    tied = (zz == zz[:, :, :1]).all(dim=2)                 # (B, T3, C)
    silent = _silent_triples(xt, f)
    assert (tied & ~silent).sum() > 100 * C and silent.sum() > 100 * C
    for region in (tied & ~silent, silent):
        g = np.where(region.numpy(), _cotangent(shape, seed=4), 0).astype(np.float32)
        got = sf.sinc_abs_pool_bwd_plain(xt, f, torch.from_numpy(g))
        share = (torch.from_numpy(g)[:, :, None, :] / 3
                 * torch.where(zz >= 0, 1.0, -1.0) * region[:, :, None, :])
        gz = torch.zeros_like(z)
        gz[:, : 3 * t3] = share.reshape(2, 3 * t3, C)
        want = torch.einsum("btc,btk->ck", gz.double(), xt.double().unfold(1, K, 1)).float()
        assert want.abs().max() > 0
        _close(got, want.numpy(), 1e-5, "even split")
        _close(got, _jax_dfilters(x, f, g), 1e-4, "ties vs adfmsl")


def test_function_backward_calls_the_plain_version_on_cpu(monkeypatch):
    calls = []
    plain = sf.sinc_abs_pool_bwd_plain

    def spy(x, filters, g, precision):
        calls.append(precision)
        return plain(x, filters, g, precision)
    monkeypatch.setattr(sf, "sinc_abs_pool_bwd_plain", spy)
    before = sf.sinc_abs_pool_bwd.launches
    f = _filters().requires_grad_(True)
    x = torch.from_numpy(_x((1, 1500), seed=5))
    g = torch.from_numpy(_cotangent((1, 1500), seed=6))
    (df,) = torch.autograd.grad(sf.sinc_abs_pool(x, f), (f,), g)
    (df32,) = torch.autograd.grad(sf.sinc_abs_pool(x, f, True), (f,), g)
    assert calls == ["tf32", "3xtf32"]        # cuDNN's TF32 default; exact f32
    assert sf.sinc_abs_pool_bwd.launches == before            # no kernel ran
    torch.testing.assert_close(df, plain(x, f.detach(), g), rtol=0, atol=0)
    torch.testing.assert_close(df32, df, rtol=0, atol=0)      # the CPU is f32 either way


def test_filter_layouts_read_back_bit_for_bit():
    f = torch.from_numpy(np.random.default_rng(7).standard_normal((144, 251))
                         .astype(np.float32))
    for dtype, e, want in ((torch.bfloat16, 8, f.to(torch.bfloat16)),
                           (torch.float32, 4, sf.tf32_round(f))):
        lay = sf.kernel_filter_layout(f, dtype)
        assert lay.dtype == dtype and lay.numel() == 192 * 256
        back = lay.reshape(3, 8, 256 // e, 8, e).permute(0, 1, 3, 2, 4).reshape(192, 256)
        assert torch.equal(back[:144, :251], want)
        assert not back[144:].any() and not back[:, 251:].any()   # zero padding


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                                   # a TF32 value
    vals = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                         one + 2.0 ** -11, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(sf.tf32_round(vals), want)


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Inputs the backward kernel does not take raise in the wrapper's checks,
    before the library is built or loaded."""
    def no_build():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(sf, "_bwd_lib", no_build)
    f = _filters()
    x = torch.zeros(2, 1000)
    g = torch.zeros(2, (1000 - K + 1) // 3, C)
    for bad in ((x.double(), f, g, "tf32"), (x[:, ::2], f, g, "tf32"),
                (x, f[:120], g, "tf32"), (x, torch.zeros(128, 300), g, "tf32"),
                (x[:, :252], f, g, "tf32"), (x, f, g[:, 1:], "tf32"),
                (x, f, g.double(), "tf32"), (x, f, g, "bf16")):
        with pytest.raises(ValueError):
            sf._bwd_launch(*bad)
    with pytest.raises(ValueError):
        sf.sinc_abs_pool_bwd(x.to("meta"), f, g, "tf32")


def test_near_tie_mask_spares_exact_ties():
    shape = (1, 6000)
    x = torch.from_numpy(_tie_x(shape, seed=8))
    f = _filters()
    loose = sf.near_tie_mask(x, f, "tf32")
    tight = sf.near_tie_mask(x, f, "3xtf32")
    assert loose.shape == (1, (6000 - K + 1) // 3, C) and loose.dtype == torch.bool
    assert bool((tight <= loose).all()) and 0 < int(tight.sum()) < int(loose.sum()) < loose.numel() // 4
    assert not loose[0, 1000 // 3 + 1:(2500 - K) // 3].any()     # the constant stretch


# ---- on the card ------------------------------------------------------------

CARD_CASES = [("jax_case", 2, 8000, C, K), ("ragged", 3, 8001, C, K),
              ("b12_cut64600", 12, 64600, C, K), ("c256_k129", 3, 5000, 256, 129),
              ("c16_k7", 3, 5000, 16, 7), ("ties", 2, 8000, C, K)]


def _card_case(name, b, t, c, k):
    x = (_tie_x if name == "ties" else _x)((b, t), seed=11)
    g = _cotangent((b, t), seed=12, c=c, k=k)
    return (torch.from_numpy(x).cuda(), _filters(c, k).cuda(), torch.from_numpy(g).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sf.PRECISIONS)
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(case, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU form")
    x, f, g = _card_case(*case)
    near = sf.near_tie_mask(x, f, precision)
    g = torch.where(near, 0.0, g)
    print(f"{case[0]} {precision}: {int(near.sum())} near-tie triples of {near.numel()} "
          "zeroed on both sides")
    want = sf.sinc_abs_pool_bwd_plain(x, f, g, precision)
    before = sf.sinc_abs_pool_bwd.launches
    got = sf.sinc_abs_pool_bwd(x, f, g, precision)
    torch.cuda.synchronize()
    assert sf.sinc_abs_pool_bwd.launches == before + 1
    _close(got, want.cpu().numpy(), CARD_TOL[precision], f"{case[0]} {precision}")


@pytest.mark.cuda
@pytest.mark.parametrize("exact_fp32", [False, True], ids=["tf32", "3xtf32"])
def test_function_launches_the_kernel_once_per_backward_on_card(exact_fp32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel has no CPU form")
    x, f, g = _card_case("jax_case", 2, 8000, C, K)
    f.requires_grad_(True)
    fwd, bwd = sf.sinc_abs_pool_fused.launches, sf.sinc_abs_pool_bwd.launches
    y = sf.sinc_abs_pool(x, f, exact_fp32)
    (df,) = torch.autograd.grad(y, (f,), g)
    torch.cuda.synchronize()
    assert sf.sinc_abs_pool_fused.launches == fwd + 1
    assert sf.sinc_abs_pool_bwd.launches == bwd + 1
    assert df.shape == f.shape and bool(torch.isfinite(df).all())
