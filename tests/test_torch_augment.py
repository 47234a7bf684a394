"""Waveform augmentation of the port (``adfmsl_torch/data/augment.py``) and its
place in the train step, against ``adfmsl/data/augment.py`` and
``adfmsl/train/steps.py:53-71``.

The two packages' random bits cannot match, so each transform's
deterministic part takes adfmsl's own draws, reproduced from a JAX key as
adfmsl makes them (``augment_waveform`` splits its key into k1-k4;
``add_noise_snr`` splits k1 into a clip index and an SNR; the gates are
``uniform(k2)`` and ``uniform(k4)``, the RIR index ``randint(k3)``).
Tolerances: noise and gates within 1e-6 of max|adfmsl|; the FFT reverb
within 1e-5 * max|x|; ``synthetic_rir`` from adfmsl's noise within 1e-6.
The draws themselves are held by their statistics: an exact SNR at min =
max, the gates' rates within 4 sigma over 4,096 rows. Gated-off rows are the
input bit for bit in both packages even where the other branch is NaN.

In the train step (maze5 at cut 4000, batch 4, its dropout and SpecAugment
on): the step with banks equals, bit for bit (loss, gradients, BN buffers,
generator states), the plain step fed the same draws' augmented audio; it
equals the plain step without ``augment_enabled`` or without a bank; under
``train.remat`` it equals the non-remat augmented step. The 'augment'
stream leaves the seeds of 'dropout', 'specaugment' and 'lsa' as they were.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.data import augment as jaug
from adfmsl_torch.config import make_experiment
from adfmsl_torch.data.augment import (AugmentDraws, add_noise_snr, apply_augment,
                                       augment_waveform, draw_augment, mix_at_snr,
                                       rir_from_noise, rir_reverb, synthetic_rir)
from adfmsl_torch.models import build_model
from adfmsl_torch.train import Optimizer, TrainState, make_train_step

CUT, BATCH = 4000, 4
NOISE_RTOL, REVERB_TOL, RIR_TOL = 1e-6, 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_draws(key, b, n_noise, n_rir, lo, hi) -> AugmentDraws:
    """adfmsl's draws of ``augment_waveform(x, key, ...)`` for ``b`` rows."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ka, kb = jax.random.split(k1)
    return AugmentDraws(
        noise_idx=_t(jax.random.randint(ka, (b,), 0, n_noise), torch.long),
        snr_db=_t(jax.random.uniform(kb, (b, 1), minval=lo, maxval=hi)),
        noise_u=_t(jax.random.uniform(k2, (b, 1))),
        rir_idx=_t(jax.random.randint(k3, (b,), 0, n_rir), torch.long),
        reverb_u=_t(jax.random.uniform(k4, (b, 1))))


def _signals(seed, b=6, t=3000, n_noise=3, n_rir=2, r=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t)) * rng.uniform(0.1, 2.0, (b, 1))).astype(np.float32)
    noise = rng.standard_normal((n_noise, t)).astype(np.float32)
    rirs = np.stack([np.asarray(jaug.synthetic_rir(jax.random.PRNGKey(10 + i), r))
                     for i in range(n_rir)])
    return x, noise, rirs


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


def test_add_noise_snr_matches_adfmsl_on_its_draws():
    x, noise, _ = _signals(0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaug.add_noise_snr(jnp.asarray(x), jnp.asarray(noise), key, 5.0, 20.0))
    ka, kb = jax.random.split(key)
    idx = _t(jax.random.randint(ka, (x.shape[0],), 0, noise.shape[0]), torch.long)
    snr = _t(jax.random.uniform(kb, (x.shape[0], 1), minval=5.0, maxval=20.0))
    got = mix_at_snr(_t(x), _t(noise)[idx], snr)
    _close(got, want, NOISE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("form", ["synthetic", "pre_delay", "tied_peaks", "per_row"])
def test_rir_reverb_matches_adfmsl(form):
    """A synthetic RIR peaks at 0; a measured-style one carries pre-delay
    (its peak at 37 is rolled to 0); tied peaks (|-0.9| at 5 and 0.9 at 9)
    roll by the first maximum in both packages; and one RIR a row."""
    x, _, rirs = _signals(1)
    rng = np.random.default_rng(5)
    if form == "synthetic":
        rir = rirs[0]
    elif form == "pre_delay":
        rir = (0.05 * rng.standard_normal(300)).astype(np.float32)
        rir[37] = 1.0
    elif form == "tied_peaks":
        rir = (0.05 * rng.standard_normal(64)).astype(np.float32)
        rir[5], rir[9] = -0.9, 0.9
    else:
        rir = rirs[np.arange(x.shape[0]) % len(rirs)]
    want = np.asarray(jaug.rir_reverb(jnp.asarray(x), jnp.asarray(rir)))
    got = rir_reverb(_t(x), _t(rir))
    _close(got, want, REVERB_TOL * np.abs(x).max())
    if form in ("pre_delay", "tied_peaks"):
        k = 37 if form == "pre_delay" else 5
        rolled = rir_reverb(_t(x), _t(np.roll(rir, -k)))
        assert torch.equal(got, rolled)


def test_synthetic_rir_from_adfmsl_noise():
    key = jax.random.PRNGKey(7)
    want = np.asarray(jaug.synthetic_rir(key, 2048))
    noise = _t(jax.random.normal(key, (2048,)))
    got = rir_from_noise(noise)
    _close(got, want, RIR_TOL)
    assert abs(float((got * got).sum()) - 1) < 1e-5
    g = torch.Generator().manual_seed(0)
    rir = synthetic_rir(g, 512)
    assert rir.shape == (512,) and torch.isfinite(rir).all()


@pytest.mark.parametrize("probs", [(0.5, 0.5), (1.0, 1.0), (0.3, 0.8)])
def test_augment_waveform_matches_adfmsl_on_its_draws(probs):
    x, noise, rirs = _signals(2, b=8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.augment_waveform(jnp.asarray(x), key, jnp.asarray(noise),
                                            jnp.asarray(rirs), *probs, 5.0, 20.0))
    d = jax_draws(key, x.shape[0], len(noise), len(rirs), 5.0, 20.0)
    got = apply_augment(_t(x), d, _t(noise), _t(rirs), *probs)
    _close(got, want, REVERB_TOL * np.abs(x).max())
    off = ((d.noise_u >= probs[0]) & (d.reverb_u >= probs[1])).squeeze(1).numpy()
    assert np.array_equal(want[off], x[off]) and torch.equal(got[off], _t(x)[off])


def test_snr_is_exact_at_min_equal_max():
    t = np.arange(8000) / 16000
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)[None].repeat(4, 0) * np.float32(0.7)
    noise = np.random.default_rng(0).standard_normal((3, 8000)).astype(np.float32)
    y = add_noise_snr(_t(x), _t(noise), torch.Generator().manual_seed(1), 10.0, 10.0)
    d = y.double().numpy() - x.astype(np.float64)
    snr = 10 * np.log10(np.mean(x.astype(np.float64) ** 2, -1) / np.mean(d ** 2, -1))
    assert np.all(np.abs(snr - 10.0) <= 1e-3), snr


def test_probabilities_zero_and_one():
    x, noise, rirs = _signals(3)
    xt = _t(x)
    none = augment_waveform(xt, torch.Generator().manual_seed(0), _t(noise), _t(rirs),
                            noise_prob=0.0, reverb_prob=0.0)
    assert torch.equal(none, xt)
    for n_p, r_p, banks in ((1.0, 1.0, (noise, rirs)), (1.0, 0.0, (noise, None)),
                            (0.0, 1.0, (None, rirs))):
        out = augment_waveform(xt, torch.Generator().manual_seed(0),
                               *(None if b is None else _t(b) for b in banks),
                               noise_prob=n_p, reverb_prob=r_p)
        assert bool((out != xt).any(dim=1).all())


def test_gate_rates_over_4096_rows():
    n, t = 4096, 32
    x = torch.randn(n, t, generator=torch.Generator().manual_seed(0))
    noise = torch.randn(4, t, generator=torch.Generator().manual_seed(1))
    rirs = torch.stack([synthetic_rir(torch.Generator().manual_seed(i), 8) for i in range(2)])
    g = torch.Generator().manual_seed(2)
    d = draw_augment(n, torch.Generator().manual_seed(2), len(noise), len(rirs))
    out = augment_waveform(x, g, noise, rirs, noise_prob=0.5, reverb_prob=0.3)
    noised = d.noise_u.squeeze(1) < 0.5
    reverbed = d.reverb_u.squeeze(1) < 0.3
    for rate, p in ((noised.float().mean(), 0.5), (reverbed.float().mean(), 0.3)):
        assert abs(float(rate) - p) <= 4 * np.sqrt(p * (1 - p) / n), (float(rate), p)
    changed = (out != x).any(dim=1)
    assert torch.equal(changed, noised | reverbed)
    assert torch.equal(out[~changed], x[~changed])
    assert int(d.noise_idx.min()) == 0 and int(d.noise_idx.max()) == len(noise) - 1
    assert float(d.snr_db.min()) >= 5.0 and float(d.snr_db.max()) < 20.0


def test_gated_off_rows_are_the_input_even_beside_nan():
    """ROADMAP's check of adfmsl's ``jnp.where`` gates (augment.py:85-93):
    a noise clip of inf makes the noised branch NaN (scale 0 times inf), and
    a row of zeros makes the reverb's energy ratio 0 / 1e-12; the gated-off
    rows still come out as the input, bit for bit, in both packages."""
    x, noise, rirs = _signals(4, b=8)
    x[3] = 0.0
    noise[:] = np.inf
    key = jax.random.PRNGKey(5)
    d = jax_draws(key, x.shape[0], len(noise), len(rirs), 5.0, 20.0)
    want = np.asarray(jaug.augment_waveform(jnp.asarray(x), key, jnp.asarray(noise),
                                            jnp.asarray(rirs), 0.5, 0.5, 5.0, 20.0))
    got = apply_augment(_t(x), d, _t(noise), _t(rirs), 0.5, 0.5)
    n_on = d.noise_u.squeeze(1).numpy() < 0.5
    off = ~n_on & (d.reverb_u.squeeze(1).numpy() >= 0.5)
    assert n_on.any() and off.any()
    assert np.isnan(want[n_on]).all() and torch.isnan(got[torch.from_numpy(n_on)]).all()
    assert np.array_equal(want[off], x[off])
    assert torch.equal(got[torch.from_numpy(off)], _t(x)[torch.from_numpy(off)])


# ---------------------------------------------------------------------------
# the train step

def _exp(augment=True, remat=False):
    exp = make_experiment("maze5")
    exp.data.cut = CUT
    exp.data.augment_enabled = augment
    exp.data.augment_noise_prob = exp.data.augment_reverb_prob = 0.5
    exp.train.remat = remat
    return exp


def _banks():
    rng = np.random.default_rng(9)
    noise = torch.from_numpy(rng.standard_normal((3, CUT)).astype(np.float32))
    rirs = torch.stack([synthetic_rir(torch.Generator().manual_seed(i), 256)
                        for i in range(2)])
    return noise, rirs


def _batch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((0.3 * rng.standard_normal((BATCH, CUT))).astype(np.float32))
    return x, torch.tensor([0, 1, 1, 0]), torch.ones(BATCH, dtype=torch.bool)


def _run(exp, x, y, m, **banks):
    model = build_model(exp.model, device="cpu", seed=0)
    st = TrainState(model, Optimizer.for_model(exp, model, 10, 1), seed=0)
    gens = st.generators(0, 0)
    met = make_train_step(exp, **banks)(st, x, y, m, gens)
    assert float(met["skipped"]) == 0.0 and torch.isfinite(met["loss"])
    return {"loss": met["loss"].clone(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "generators": {k: g.get_state() for k, g in gens.items()}}


def _assert_equal_steps(a, b):
    assert torch.equal(a["loss"], b["loss"])
    for part in ("grads", "buffers", "generators"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


@pytest.fixture(scope="module")
def plain_step():
    """The plain step on the un-augmented batch; a step first, not compared: a
    process's first oneDNN calls on a loaded host do not always round as its
    later ones do."""
    x, y, m = _batch()
    _run(_exp(False), x, y, m)
    return _run(_exp(False), x, y, m)


def test_train_step_augments_with_the_augment_stream(plain_step):
    noise, rirs = _banks()
    x, y, m = _batch()
    aug = _run(_exp(), x, y, m, noise_bank=noise, rir_bank=rirs)
    # the plain step, fed the audio of the same draws
    exp = _exp()
    model = build_model(exp.model, device="cpu", seed=0)
    st = TrainState(model, Optimizer.for_model(exp, model, 10, 1), seed=0)
    gens = st.generators(0, 0)
    xa = augment_waveform(x, gens["augment"], noise, rirs, 0.5, 0.5,
                          exp.data.augment_snr_db_min, exp.data.augment_snr_db_max)
    assert not torch.equal(xa, x) and bool((xa == x).all(dim=1).any())
    met = make_train_step(_exp(False))(st, xa, y, m, gens)
    fed = {"loss": met["loss"].clone(),
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "buffers": {n: b.clone() for n, b in model.named_buffers()},
           "generators": {k: g.get_state() for k, g in gens.items()}}
    _assert_equal_steps(aug, fed)
    assert not torch.equal(aug["loss"], plain_step["loss"])


@pytest.mark.parametrize("case", ["augment_disabled", "no_bank"])
def test_train_step_without_augmentation_is_the_plain_step(case, plain_step):
    noise, rirs = _banks()
    x, y, m = _batch()
    if case == "augment_disabled":
        got = _run(_exp(False), x, y, m, noise_bank=noise, rir_bank=rirs)
    else:
        got = _run(_exp(True), x, y, m)
    _assert_equal_steps(got, plain_step)


def test_remat_augmented_step_equals_the_plain_augmented_step():
    noise, rirs = _banks()
    x, y, m = _batch()
    plain = _run(_exp(), x, y, m, noise_bank=noise, rir_bank=rirs)
    remat = _run(_exp(remat=True), x, y, m, noise_bank=noise, rir_bank=rirs)
    _assert_equal_steps(plain, remat)


def test_augment_stream_leaves_the_other_seeds():
    """The three streams' seeds as they were before 'augment' was added."""
    model = torch.nn.Linear(1, 1)
    st = TrainState(model, None, seed=1234)
    want = {(0, 0, 0): (4074205681640135330, 4836205983272133661, 4035985887792116817),
            (3, 17, 0): (4660904366440689530, 5988782405054095931, 1799824755614878038),
            (1, 2, 1): (2212036448886904303, 8420117347932844350, 6303834715969868160)}
    for at, seeds in want.items():
        gens = st.generators(*at)
        assert tuple(gens[k].initial_seed() for k in ("dropout", "specaugment", "lsa")) == seeds
        assert len({g.initial_seed() for g in gens.values()}) == 4
