"""K4 (fused LFCC) in the port vs adfmsl.

The port's plain version (adfmsl_torch.ops.lfcc_fused.lfcc_fused_plain) is
held against adfmsl's Pallas kernel in interpret mode on test_pallas.py's
inputs ((2, 16000), (1, 64600) with its 404 frames, (1, 16000)) at the three
tiers, within 1e-5 * max|ref| (the rounding points agree; only the order of
the f32 sums differs). On the CPU, adfmsl's 'default' pass multiplies the f32
frames by the bf16 DFT matrix (the CPU does not round an f32 operand to bf16
as the TPU's one-pass product does), so at 'default' adfmsl is given the
bf16-rounded waveform, which is what the TPU's pass, and the port's, round
to. The CUDA kernel is held against the plain version on the card (marker
``cuda``) within 1e-4 * max|plain|, test_pallas.py's tolerance.

JAX is imported inside the tests that compare with adfmsl, so that the card
test also runs on a machine without JAX:
    python -m pytest --noconftest -q tests/test_torch_lfcc_fused.py -m cuda
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.ops import lfcc_fused as lf
from adfmsl_torch.ops.stft import _dft_matrices, bf16_round

SHAPES = [(2, 16000), (1, 64600), (1, 16000)]
IDS = ["jax_case", "ragged_404_frames", "tile_case"]
TIERS = ["high", "default", "highest"]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_pallas_interpret(shape, precision):
    jnp = pytest.importorskip("jax.numpy")
    from adfmsl.ops.pallas.lfcc_fused import lfcc_fused as jax_lfcc_fused

    x = _x(shape, seed=len(shape) + shape[1])
    x_ref = bf16_round(torch.from_numpy(x)).numpy() if precision == "default" else x
    ref = np.asarray(jax_lfcc_fused(jnp.asarray(x_ref), precision=precision,
                                    interpret=True))
    got = lf.lfcc_fused_plain(torch.from_numpy(x), precision=precision)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (shape[0], 1 + shape[1] // 160, 60)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_kernel_operands_hold_the_plain_versions_matrices():
    """The chunked DFT matrix the kernel streams reassembles into the plain
    version's [re | im] (zero past win and the last bin), split into bf16 hi
    and lo exactly as the plain version rounds; the filterbank is zero-padded."""
    cpu = torch.device("cpu")
    w_hi, w_lo, fb, dct, n_chunks = lf.kernel_operands(16000, 512, 400, 70, 60, "high", cpu)
    assert n_chunks == 17 and tuple(w_hi.shape) == (17, 400, 32)
    assert w_hi.dtype == w_lo.dtype == torch.bfloat16
    cre, cim = _dft_matrices(512, 400)
    w = (w_hi.float() + w_lo.float()).numpy()
    re = np.concatenate([w[c, :, :16] for c in range(n_chunks)], axis=1)
    im = np.concatenate([w[c, :, 16:] for c in range(n_chunks)], axis=1)
    cat = torch.from_numpy(np.concatenate([cre, cim], axis=1))
    hi = bf16_round(cat)
    lo = bf16_round(cat - hi)
    np.testing.assert_array_equal(re[:, :257], (hi + lo).numpy()[:, :257])
    np.testing.assert_array_equal(im[:, :257], (hi + lo).numpy()[:, 257:])
    assert not re[:, 257:].any() and not im[:, 257:].any()
    assert tuple(fb.shape) == (272, 72) and not fb[257:].any() and not fb[:, 70:].any()
    assert tuple(dct.shape) == (70, 60)
    f32, none, *_ = lf.kernel_operands(16000, 512, 400, 70, 60, "highest", cpu)
    assert f32.dtype == torch.float32 and none is None


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    x = torch.from_numpy(_x((1, 4000)))
    before = lf.lfcc_fused.launches
    assert torch.equal(lf.lfcc_fused(x), lf.lfcc_fused_plain(x))
    assert lf.lfcc_fused.launches == before          # no kernel ran
    with pytest.raises(ValueError):
        lf.lfcc_fused(x.to("meta"))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Inputs the CUDA kernel does not take raise in the wrapper's checks, which
    run before the library is built or loaded."""
    x = torch.zeros(2, 1000)
    for bad, kw in ((x.double(), {}), (x[:, ::2], {}), (x[0], {}), (x[:, :200], {}),
                    (x, {"hop_length": 100}), (x, {"n_filter": 129}),
                    (x, {"n_lfcc": 200}), (x, {"precision": "HIGH"})):
        args = {"sample_rate": 16000, "n_fft": 512, "hop_length": 160, "win_length": 400,
                "n_filter": 70, "n_lfcc": 60, "log_eps": 1e-6, "precision": "high", **kw}
        with pytest.raises(ValueError):
            lf._launch(bad, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("shape", SHAPES[:2] + [(16, 64600)],
                         ids=IDS[:2] + ["b16_cut64600"])
def test_kernel_matches_plain_on_card(shape, precision, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K4 kernel has no CPU form")
    x = torch.from_numpy(_x(shape, seed=7)).cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    want = lf.lfcc_fused_plain(x, precision=precision)
    before = lf.lfcc_fused.launches
    got = lf.lfcc_fused(x, precision=precision)
    torch.cuda.synchronize()
    assert lf.lfcc_fused.launches == before + 1
    assert got.shape == want.shape
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
