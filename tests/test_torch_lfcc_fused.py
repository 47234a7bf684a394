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


OPERAND_SHAPES = [(16000, 512, 160, 400, 70, 60, 8), (16000, 1024, 128, 512, 70, 60, 16)]


@pytest.mark.parametrize("sr,n_fft,hop,win,nf,nl,n_chunks", OPERAND_SHAPES,
                         ids=["model", "nfft1024_hop128_win512"])
def test_kernel_operands_hold_the_plain_versions_matrices(sr, n_fft, hop, win, nf, nl,
                                                          n_chunks):
    """The W stages, read back by the kernel's own address arithmetic (the B
    descriptor's no-swizzle K-major core matrices: element (column n, tap k) of
    a 64 x 80 slice at ((n/8)*10 + k/8)*64 + (n%8)*8 + k%8), reassemble the
    plain version's [re | im] with re and im of bin 32c + i in columns 2i and
    2i + 1, zero past win, split into bf16 hi and lo exactly as the plain
    version rounds; the chunks stop at the last bin a filter reads; the CSR
    filterbank reassembles ``linear_filterbank`` exactly; 'highest' keeps its
    dense operands."""
    from adfmsl_torch.ops.mel import linear_filterbank

    cpu = torch.device("cpu")
    fbm = linear_filterbank(sr, n_fft, nf)
    assert n_chunks == -(-(1 + int(np.flatnonzero(fbm.any(axis=1)).max())) // 32)
    n_bins = n_fft // 2 + 1
    kp = 80 * -(-win // 80)
    cre, cim = _dft_matrices(n_fft, win)
    cat = torch.from_numpy(np.concatenate([cre, cim], axis=1))
    want_hi = bf16_round(cat)
    want_lo = bf16_round(cat - want_hi)
    for precision, planes in (("high", 2), ("default", 1)):
        ops = lf.kernel_operands(sr, n_fft, win, nf, nl, precision, cpu)
        assert ops.n_chunks == n_chunks
        assert ops.w.dtype == torch.bfloat16
        assert tuple(ops.w.shape) == (n_chunks * kp // 80, planes, 64 * 80)
        w = ops.w.float().numpy()
        n = np.arange(64)[:, None]
        k = np.arange(80)[None, :]
        idx = ((n // 8) * 10 + k // 8) * 64 + (n % 8) * 8 + k % 8
        dense = np.zeros((planes, kp, n_chunks * 32, 2), np.float32)  # (tap, bin, re / im)
        for c in range(n_chunks):
            for s in range(kp // 80):
                blk = w[c * (kp // 80) + s][:, idx]                     # (planes, n, k)
                dense[:, 80 * s:80 * (s + 1), 32 * c:32 * (c + 1)] = (
                    blk.reshape(planes, 32, 2, 80).transpose(0, 3, 1, 2))
        nb = n_chunks * 32
        for p, want in enumerate((want_hi, want_lo)[:planes]):
            want = want.numpy()
            np.testing.assert_array_equal(dense[p, :win, :, 0], want[:, :nb])
            np.testing.assert_array_equal(dense[p, :win, :, 1], want[:, n_bins:n_bins + nb])
            assert not dense[p, win:].any()                            # padded taps
        # the CSR filterbank, and the filters each chunk's pass visits
        idx_ = ops.fb_index.numpy()
        first, last, off = idx_[:nf], idx_[nf:2 * nf], idx_[2 * nf:3 * nf]
        jlo, jhi = idx_[3 * nf:3 * nf + n_chunks], idx_[3 * nf + n_chunks:]
        back = np.zeros_like(fbm)
        vals = ops.fb.numpy()
        for j in range(nf):
            back[first[j]:last[j] + 1, j] = vals[off[j]:off[j] + last[j] - first[j] + 1]
        np.testing.assert_array_equal(back, fbm)
        assert ops.fb.numel() == (last - first + 1).sum()
        for c in range(n_chunks):
            touching = [j for j in range(nf) if first[j] <= 32 * c + 31 and last[j] >= 32 * c]
            assert (jlo[c], jhi[c]) == (touching[0], touching[-1] + 1)
        assert tuple(ops.dct.shape) == (nf, nl)
    if n_fft == 512:
        assert vals.size == 504
        f32 = lf.kernel_operands(sr, n_fft, win, nf, nl, "highest", cpu)
        assert f32.w.dtype == torch.float32 and tuple(f32.w.shape) == (17, 400, 32)
        assert f32.fb_index is None and f32.n_chunks == 17
        w = f32.w.numpy()
        re = np.concatenate([w[c, :, :16] for c in range(17)], axis=1)
        im = np.concatenate([w[c, :, 16:] for c in range(17)], axis=1)
        np.testing.assert_array_equal(re[:, :257], cre)
        np.testing.assert_array_equal(im[:, :257], cim)
        assert not re[:, 257:].any() and not im[:, 257:].any()
        fb = f32.fb.numpy()
        assert fb.shape == (272, 72) and not fb[257:].any() and not fb[:, 70:].any()
        np.testing.assert_array_equal(fb[:257, :70], fbm)


def test_smem_layout_fits_the_model_and_the_widest_filterbank():
    """The shared-memory formula the wrapper shares with the kernel
    (``csrc/lfcc_fused.cu:tc_layout``): two warpgroups and a 3-stage W ring at
    the model's shape (70 filters: 730 words of CSR tables), 2 stages at 128
    filters and coefficients, 66 frame rows at the model's hop of 160 (pitch
    168); one warpgroup from a hop of 256 at 'high'; a row holds at most kp
    samples, so a hop past the window costs no more than the window."""
    cpu = torch.device("cpu")
    words = lf.kernel_operands(16000, 512, 400, 70, 60, "high", cpu).fb_words
    assert words == 3 * 70 + 2 * 8 + 504
    model = lf.tc_smem_layout(160, 400, 70, 60, "high", words)
    assert (model["cols"], model["pitch"], model["rows"]) == (160, 168, 66)
    assert (model["warpgroups"], model["stages"]) == (2, 3)
    assert model["total"] == 206848 <= lf.SMEM_LIMIT
    assert lf.tc_smem_layout(160, 400, 70, 60, "default", words)["total"] < model["total"]
    wide_words = lf.kernel_operands(16000, 512, 400, 128, 128, "high", cpu).fb_words
    wide = lf.tc_smem_layout(160, 400, 128, 128, "high", wide_words)
    assert (wide["warpgroups"], wide["stages"]) == (2, 2) and wide["total"] <= lf.SMEM_LIMIT
    assert lf.tc_smem_layout(128, 512, 70, 60, "high", words)["pitch"] == 136  # 128/8 even
    assert lf.tc_smem_layout(8, 400, 70, 60, "high", words)["rows"] == 64 + 50 - 1
    assert lf.tc_smem_layout(224, 400, 70, 60, "high", words)["warpgroups"] == 2
    for hop in (256, 320, 1024):
        one = lf.tc_smem_layout(hop, 400, 70, 60, "high", words)
        assert (one["warpgroups"], one["stages"]) == (1, 3)
        assert lf.tc_smem_layout(hop, 400, 70, 60, "default", words)["warpgroups"] == 2
    far = lf.tc_smem_layout(1024, 400, 70, 60, "high", words)
    assert (far["cols"], far["pitch"], far["rows"]) == (400, 408, 64)
    assert far["total"] == lf.tc_smem_layout(400, 400, 70, 60, "high", words)["total"]
    assert lf.tc_smem_layout(2048, 4096, 70, 60, "high", words) is None


def _first_form_smem(precision, hop, win, nf, nl):
    """Shared memory a CTA of the wmma kernel that ran 'high' and 'default'
    before the tensor-core engine: its 64 frames' (63 * hop + kp16) samples in
    bf16 hi (and lo), a chunk of 16 bins' W (kp16 x 32 bf16 hi and lo) sharing
    its space with the log energies and the output tile, an f32 stage and the
    chunk's dense filterbank rows."""
    a128 = lambda v: (v + 127) & ~127  # noqa: E731
    kp, nfp, planes = 16 * -(-win // 16), 4 * -(-nf // 4), 2 if precision == "high" else 1
    xs = planes * a128((63 * hop + kp) * 2)
    w = planes * a128(kp * 32 * 2)
    total = a128(xs + max(64 * (nfp + nl) * 4, w))
    return a128(a128(total + 64 * 36 * 4) + 16 * nfp * 4)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_smem_layout_serves_every_shape_the_first_form_took(precision):
    """Every (hop, win, filters, coefficients) whose CTA fitted 227 KB in the
    wmma kernel the engine replaced fits the engine too (``tc_smem_layout``
    not None): the engine may drop to one warpgroup a CTA, never refuse what
    the first form ran. The CSR words are the filterbank's own."""
    from adfmsl_torch.ops.mel import linear_filterbank

    checked = 0
    for nf, nl in ((1, 1), (20, 20), (70, 60), (128, 128), (128, 1), (1, 128)):
        for win in (16, 64, 200, 256, 400, 512, 1024, 2048):
            n_fft = max(512, 1 << (win - 1).bit_length())
            first, last, _, vals = lf.filterbank_csr(linear_filterbank(16000, n_fft, nf))
            words = 3 * nf + 2 * -(-(int(last.max()) + 1) // 32) + vals.size
            for hop in range(8, 4097, 8):
                if _first_form_smem(precision, hop, win, nf, nl) <= lf.SMEM_LIMIT:
                    checked += 1
                    assert lf.tc_smem_layout(hop, win, nf, nl, precision, words), \
                        (precision, hop, win, nf, nl)
    assert checked > 1000
    assert _first_form_smem("high", 320, 400, 70, 60) < lf.SMEM_LIMIT   # hop 320 ran


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    x = torch.from_numpy(_x((1, 4000)))
    before = lf.lfcc_fused.launches
    assert torch.equal(lf.lfcc_fused(x), lf.lfcc_fused_plain(x))
    assert lf.lfcc_fused.launches == before          # no kernel ran
    with pytest.raises(ValueError):
        lf.lfcc_fused(x.to("meta"))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Inputs the CUDA kernel does not take raise in the wrapper's checks, which
    run before the library is built or loaded; a shape whose frame buffer does
    not fit shared memory even at one warpgroup a CTA (``tc_smem_layout``: a
    window of 4096 at a hop of 2048) among them, at both tensor-core tiers."""
    def no_build():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(lf, "_kernel_lib", no_build)
    x = torch.zeros(2, 1000)
    for bad, kw in ((x.double(), {}), (x[:, ::2], {}), (x[0], {}), (x[:, :200], {}),
                    (x, {"hop_length": 100}), (x, {"n_filter": 129}),
                    (x, {"n_lfcc": 200}), (x, {"precision": "HIGH"})):
        args = {"sample_rate": 16000, "n_fft": 512, "hop_length": 160, "win_length": 400,
                "n_filter": 70, "n_lfcc": 60, "log_eps": 1e-6, "precision": "high", **kw}
        with pytest.raises(ValueError):
            lf._launch(bad, **args)
    long = torch.zeros(2, 8000)
    for precision in ("high", "default"):
        with pytest.raises(ValueError, match="shared memory"):
            lf._launch(long, 16000, 4096, 2048, 4096, 70, 60, 1e-6, precision)


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


# the tile's seams (63-65, 128, 129 frames), CTAs spanning two batch rows (7 tiles
# a row, batch 3: an odd tile count, so the last CTA's second warpgroup has no
# tile), another n_fft / hop / win (hop / 8 even), the smallest hop, the widest
# filterbank, hops whose CTA holds one warpgroup at 'high' (256, 320) and a hop
# past the window (1024: a row keeps its first kp samples): (name, B, T,
# lfcc_fused keyword arguments)
SEAM_CASES = [(f"frames{1 + t // 160}", 2, t, {}) for t in (9920, 10080, 10240, 20320, 20480)]
SEAM_CASES += [("b3_7_tiles_a_row", 3, 64600, {}),
               ("nfft1024_hop128_win512", 2, 16000,
                {"n_fft": 1024, "hop_length": 128, "win_length": 512}),
               ("hop8", 2, 2000, {"hop_length": 8}),
               ("hop256", 3, 20000, {"hop_length": 256}),
               ("hop320", 3, 24000, {"hop_length": 320}),
               ("hop1024", 2, 70000, {"hop_length": 1024}),
               ("nf128_nl128", 2, 16000, {"n_filter": 128, "n_lfcc": 128})]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("case", SEAM_CASES, ids=[c[0] for c in SEAM_CASES])
def test_kernel_seams_match_plain_on_card(case, precision, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K4 kernel has no CPU form")
    _, b, t, kw = case
    x = torch.from_numpy(_x((b, t), seed=11)).cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    want = lf.lfcc_fused_plain(x, precision=precision, **kw)
    before = lf.lfcc_fused.launches
    got = lf.lfcc_fused(x, precision=precision, **kw)
    torch.cuda.synchronize()
    assert lf.lfcc_fused.launches == before + 1
    assert got.shape == want.shape
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
