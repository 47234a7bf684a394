"""K3 (fused sinc conv + |.| + MaxPool3, the RawNet front end) in the port vs
adfmsl.

The port's plain version (adfmsl_torch.ops.sinc_fused.sinc_abs_pool_plain) is
held against adfmsl's Pallas kernel in interpret mode within 1e-5 * max|ref|:
both round x and the filters to bf16 and sum the exact products in f32, so
only the order of the f32 sums differs. Against adfmsl's f32 composition
(ops/sinc.py:sinc_abs_pool3_nhc) the bf16 rounding shows, so that check takes
test_pallas.py's 2e-2. The port's own f32 composition is held against
adfmsl's at 1e-5 * max. The CUDA kernel is held against the plain version on
the card (marker ``cuda``) within 1e-3 * max|plain|.

JAX is imported inside the tests that compare with adfmsl, so that the card
test also runs on a machine without JAX:
    python -m pytest --noconftest -q tests/test_torch_sinc_fused.py -m cuda
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.models.sincnet import SincConv
from adfmsl_torch.ops import sinc_fused as sf
from adfmsl_torch.ops.sinc import sinc_abs_pool3_nhc, sinc_filters, sinc_init

SHAPES = [(2, 8000), (3, 8001)]        # T' % 3 == 1 and == 2; both ragged tiles
IDS = ["jax_case", "ragged"]


def _filters(c=128, k=251):
    low, band = sinc_init(c)
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_pallas_interpret_and_f32_composition(shape):
    jnp = pytest.importorskip("jax.numpy")
    from adfmsl.ops.pallas.sinc_fused import sinc_abs_pool_fused
    from adfmsl.ops.sinc import sinc_abs_pool3_nhc as jax_composition

    f = _filters()
    x = _x(shape)
    ref = np.asarray(sinc_abs_pool_fused(jnp.asarray(x), jnp.asarray(f.numpy()),
                                         interpret=True))
    f32 = np.asarray(jax_composition(jnp.asarray(x), jnp.asarray(f.numpy())))
    got = sf.sinc_abs_pool_plain(torch.from_numpy(x), f)
    t3 = (shape[1] - 251 + 1) // 3
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], t3, 128)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got, f32, rtol=2e-2, atol=2e-2 * np.abs(f32).max())


def test_f32_composition_matches_adfmsl():
    jnp = pytest.importorskip("jax.numpy")
    from adfmsl.ops.sinc import sinc_abs_pool3_nhc as jax_composition

    f = _filters()
    x = _x(SHAPES[1], seed=1)
    ref = np.asarray(jax_composition(jnp.asarray(x), jnp.asarray(f.numpy())))
    got = sinc_abs_pool3_nhc(torch.from_numpy(x), f).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    f = _filters()
    x = torch.from_numpy(_x((1, 1000)))
    before = sf.sinc_abs_pool_fused.launches
    assert torch.equal(sf.sinc_abs_pool_fused(x, f), sf.sinc_abs_pool_plain(x, f))
    assert sf.sinc_abs_pool_fused.launches == before          # no kernel ran
    with pytest.raises(ValueError):
        sf.sinc_abs_pool_fused(x.to("meta"), f)


def test_sinc_conv_dispatch():
    """adfmsl's rule (models/sincnet.py:82-92): at eval with fused_eval the
    front end runs K3 up to fused_max_batch rows and the f32 composition above
    it, bit for bit; without fused_eval it always runs the composition."""
    fused = SincConv(post="abs_pool3", fused_eval=True).eval()
    plain = SincConv(post="abs_pool3").eval()
    with torch.inference_mode():
        f = fused.filters()
        small = torch.from_numpy(_x((16, 2000), seed=2))
        big = torch.from_numpy(_x((17, 2000), seed=3))
        assert torch.equal(fused(small), sf.sinc_abs_pool_fused(small, f))
        assert torch.equal(fused(big), sinc_abs_pool3_nhc(big, f))
        assert torch.equal(plain(small), sinc_abs_pool3_nhc(small, f))
        assert not torch.equal(fused(small), plain(small))     # bf16 operands show
        assert tuple(fused(small).shape) == (16, (2000 - 250) // 3, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(16, 64600)], ids=IDS + ["b16_cut64600"])
def test_kernel_matches_plain_on_card(shape, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K3 kernel has no CPU form")
    f = _filters().cuda()
    x = torch.from_numpy(_x(shape, seed=4)).cuda()
    # the plain version in exact f32: no TF32 in cuDNN convs
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want = sf.sinc_abs_pool_plain(x, f)
    before = sf.sinc_abs_pool_fused.launches
    got = sf.sinc_abs_pool_fused(x, f)
    torch.cuda.synchronize()
    assert sf.sinc_abs_pool_fused.launches == before + 1
    assert got.shape == want.shape
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(256, 129), (16, 7)], ids=["c256_k129", "c16_k7"])
def test_kernel_other_widths_on_card(c, k, monkeypatch):
    """Widths the model does not use but the wrapper takes: two 16-column
    tiles per warp, and idle warps with a single 16-tap step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K3 kernel has no CPU form")
    f = _filters(c, k).cuda()
    x = torch.from_numpy(_x((3, 5000), seed=5)).cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want = sf.sinc_abs_pool_plain(x, f).cpu().numpy()
    got = sf.sinc_abs_pool_fused(x, f).cpu().numpy()
    assert got.shape == want.shape == (3, (5000 - k + 1) // 3, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * float(np.abs(want).max()))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Inputs the CUDA kernel does not take (dtype, layout, channels, taps, a
    T with no pooled row) raise in the wrapper's checks, which run before the
    library is built or loaded."""
    f = _filters()
    x = torch.zeros(2, 1000)
    for bad_x, bad_f in ((x.double(), f), (x[:, ::2], f), (x, f[:120]),
                         (x, torch.zeros(128, 300)), (x[:, :252], f)):
        with pytest.raises(ValueError):
            sf._launch(bad_x, bad_f)
