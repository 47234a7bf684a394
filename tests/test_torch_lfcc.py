"""The port's DSP front-end ops vs adfmsl's: framing, the four STFT forms at
the three precision tiers, the filterbanks and the DCT matrix, LFCC and
log-mel (with and without the fused power), and CMVN.

adfmsl on the CPU computes every tier in exact f32 (XLA's CPU backend ignores
the precision), while the port gives each tier adfmsl's TPU meaning on every
device. So the ops are held against adfmsl at 'highest' within 1e-5 *
max|ref|, and the 'high' / 'default' tiers against adfmsl's own f32 STFT on
the tier's bf16-rounded operands (its DFT matrices replaced through
``monkeypatch``, its input rounded before the call): 'default' is one pass
over x_hi and W_hi, 'high' the sum of the passes over (x_hi, W_hi),
(x_hi, W_lo) and (x_lo, W_hi), all within 1e-5 * max|ref|. The filterbanks
and the DCT matrix are the same numpy code, so they must be equal.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adfmsl_torch.ops import cmvn as port_cmvn
from adfmsl_torch.ops import lfcc as port_lfcc
from adfmsl_torch.ops import mel as port_mel
from adfmsl_torch.ops import stft as port_stft
from adfmsl_torch.ops import window as port_window

jax_cmvn = importlib.import_module("adfmsl.ops.cmvn")
jax_lfcc = importlib.import_module("adfmsl.ops.lfcc")
jax_mel = importlib.import_module("adfmsl.ops.mel")
jax_stft = importlib.import_module("adfmsl.ops.stft")
jax_window = importlib.import_module("adfmsl.ops.window")

IMPLS = ["matmul", "conv", "s2d", "fft"]
N_BINS = 257


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape,center", [((2, 1000), True), ((2, 3, 999), True),
                                          ((1, 1000), False)],
                         ids=["center", "lead_dims", "no_center"])
def test_frame_and_num_frames_match_adfmsl(shape, center):
    x = _x(shape)
    ref = np.asarray(jax_window.frame(jnp.asarray(x), 400, 160, center=center))
    got = port_window.frame(torch.from_numpy(x), 400, 160, center=center)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.shape[-2] == port_window.num_frames(shape[-1], 400, 160, center) \
        == jax_window.num_frames(shape[-1], 400, 160, center)


@pytest.mark.parametrize("impl", IMPLS)
def test_stft_impls_match_adfmsl_at_highest(impl):
    x = _x((2, 3, 4000), seed=1)
    ref = np.asarray(jax_stft.power_spectrogram(jnp.asarray(x), impl=impl,
                                                precision="highest"))
    got = port_stft.power_spectrogram(torch.from_numpy(x), impl=impl, precision="highest")
    _close(got, ref)


def _tier_reference(x, precision, monkeypatch):
    """adfmsl's f32 s2d STFT on the tier's bf16-rounded operands -> power."""
    cre, cim = jax_stft._dft_matrices(512, 400)

    def split(a):
        hi = _bf16(a)
        return hi, _bf16(a - hi)

    def run(xa, re_, im_):
        monkeypatch.setattr(jax_stft, "_dft_matrices", lambda *a, **k: (re_, im_))
        return np.asarray(jax_stft.stft_s2d(jnp.asarray(xa), precision="highest",
                                            raw=True))
    (xh, xl), (rh, rl), (ih, il) = split(x), split(cre), split(cim)
    out = run(xh, rh, ih)
    if precision == "high":
        out = out + run(xh, rl, il) + run(xl, rh, ih)
    re, im = out[..., :N_BINS], out[..., N_BINS:]
    return re * re + im * im


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("impl", ["matmul", "conv", "s2d"])
def test_stft_tiers_match_adfmsl_on_rounded_operands(impl, precision, monkeypatch):
    x = _x((2, 4000), seed=2)
    ref = _tier_reference(x, precision, monkeypatch)
    got = port_stft.power_spectrogram(torch.from_numpy(x), impl=impl, precision=precision)
    _close(got, ref)
    # the tier shows against exact f32 (so the check above could fail)
    f32 = port_stft.power_spectrogram(torch.from_numpy(x), impl=impl, precision="highest")
    assert not torch.equal(got, f32)


def test_fft_has_no_tier_and_bad_tiers_raise():
    x = torch.from_numpy(_x((1, 3000), seed=3))
    ref = port_stft.stft_fft(x, precision="highest")
    for p in ("high", "default"):
        assert torch.equal(port_stft.stft_fft(x, precision=p), ref)
    with pytest.raises(ValueError):
        port_stft.stft_matmul(x, precision="HIGH")


@pytest.mark.parametrize("kwargs", [{}, {"htk": True}, {"n_mels": 40, "fmin": 20.0,
                                                         "fmax": 7600.0},
                                    {"norm": None, "n_fft": 400}],
                         ids=["slaney", "htk", "band", "no_norm"])
def test_mel_filterbank_equals_adfmsl(kwargs):
    np.testing.assert_array_equal(port_mel.mel_filterbank(**kwargs),
                                  jax_mel.mel_filterbank(**kwargs))


@pytest.mark.parametrize("htk", [False, True], ids=["slaney", "htk"])
def test_mel_scale_equals_adfmsl(htk):
    f = np.array([0.0, 30.0, 700.0, 999.9, 1000.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(port_mel.hz_to_mel(f, htk), jax_mel.hz_to_mel(f, htk))
    m = jax_mel.hz_to_mel(f, htk)
    np.testing.assert_array_equal(port_mel.mel_to_hz(m, htk), jax_mel.mel_to_hz(m, htk))


@pytest.mark.parametrize("n_filter,n_lfcc", [(70, 60), (20, 13)])
def test_linear_filterbank_and_dct_equal_adfmsl(n_filter, n_lfcc):
    np.testing.assert_array_equal(port_mel.linear_filterbank(n_filter=n_filter),
                                  jax_mel.linear_filterbank(n_filter=n_filter))
    np.testing.assert_array_equal(port_lfcc.dct_matrix(n_filter, n_lfcc),
                                  jax_lfcc.dct_matrix(n_filter, n_lfcc))


@pytest.mark.parametrize("fused_power", [False, True], ids=["power", "fused_power"])
@pytest.mark.parametrize("fn", ["lfcc", "logmel"])
def test_lfcc_logmel_match_adfmsl(fn, fused_power):
    x = _x((2, 16000), seed=4)
    ref = np.asarray(getattr(jax_lfcc, fn)(jnp.asarray(x), precision="highest",
                                           fused_power=fused_power))
    got = getattr(port_lfcc, fn)(torch.from_numpy(x), precision="highest",
                                 fused_power=fused_power)
    assert got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("fn", ["lfcc", "logmel"])
def test_fused_power_is_the_same_math_at_each_tier(fn):
    x = torch.from_numpy(_x((1, 8000), seed=5))
    f = getattr(port_lfcc, fn)
    for p in ("high", "default"):
        a, b = f(x, precision=p), f(x, precision=p, fused_power=True)
        _close(b, a.numpy())


@pytest.mark.parametrize("var_norm", [True, False])
def test_cmvn_matches_adfmsl(var_norm):
    x = _x((2, 37, 60), seed=6) * 3.0 + 1.5
    ref = np.asarray(jax_cmvn.cmvn(jnp.asarray(x), var_norm=var_norm))
    got = port_cmvn.cmvn(torch.from_numpy(x), var_norm=var_norm)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
