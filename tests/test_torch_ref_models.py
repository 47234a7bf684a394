"""Maze models under the reference checkpoints' semantics against adfmsl:
``reference_parity_experiment`` on both sides ('reference' sinc formula and
block semantics, f32), so each trunk runs its ``MazeSpec.block_variant``.

- f32 logits at batch 2, cut 4000 (the Wav2Vec2 models at
  ``wav2vec2.model_name='tiny'``, their transformer after the trunk cut to 2
  layers by ``dataclasses.replace`` of the spec on both sides), one model a
  variant: maze5 ('reference'), maze4_fmsl ('fmsl_adaptive'), maze2
  ('maze2'), maze3 ('maze3'), maze3_fmsl ('fmsl_plain'), maze2_fmsl
  ('fmsl_se'); adfmsl's variables (BN statistics drawn at random) come across
  by ``state_dict_from_flax``. Tolerances are tests/test_port.py's for the
  same model: the log-softmax of maze5 within atol 2e-4 (:161) and of maze2
  within 1e-3 (:588), the others' logits within 1e-3 * max(1, |logits|), all
  with rtol 1e-3.
- One f32 train step of maze5 under 'reference' semantics with dropout,
  SpecAugment and LSA off, with tests/test_torch_train_step.py's checks and
  tolerances (tests/test_train_parity.py's three: the loss, per-leaf gradient
  cosine and norm, the global update's cosine and magnitude; and the BN
  statistics).
- Every registry maze model builds under ``reference_parity_experiment`` with
  its variant, and its eval forward on the tiny encoder is finite.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.models import mazes as jax_mazes
from adfmsl.models.port import reference_parity_experiment as jax_parity
from adfmsl_torch.models import MazeModel, SPECS, reference_parity_experiment
from adfmsl_torch.models import state_dict_from_flax
from test_torch_train_step import F32_TOL, one_step

CUT = 4000
# model -> (its block variant, the transformer's layers kept, tests/test_port.py's
# comparison: the log-softmax within an absolute atol, or the logits within
# atol * max(1, |logits|))
CASES = {"maze5": ("reference", None, ("log_softmax", 2e-4)),
         "maze4_fmsl": ("fmsl_adaptive", None, ("logits", 1e-3)),
         "maze2": ("maze2", 2, ("log_softmax", 1e-3)),
         "maze3": ("maze3", None, ("logits", 1e-3)),
         "maze3_fmsl": ("fmsl_plain", 2, ("logits", 1e-3)),
         "maze2_fmsl": ("fmsl_se", None, ("logits", 1e-3))}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(specs, name, layers):
    spec = specs[name]
    if layers is None:
        return spec
    d, heads, _, ff = spec.transformer
    return dataclasses.replace(spec, transformer=(d, heads, layers, ff))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_semantics_logits_match_adfmsl(name):
    variant, layers, (form, atol) = CASES[name]
    assert SPECS[name].block_variant in (variant, None)
    rng = np.random.default_rng(list(CASES).index(name))
    x = rng.standard_normal((2, CUT)).astype(np.float32)
    jexp = jax_parity(name)
    jexp.data.cut = CUT
    jexp.model.wav2vec2.model_name = "tiny"
    jm = jax_mazes.MazeModel(spec=_spec(jax_mazes.SPECS, name, layers), cfg=jexp.model)
    v = jax.jit(lambda k, a: jm.init({"params": k}, a, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    params = _np(v["params"])
    stats = jax.tree.map(lambda a: (np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.1)
                         .astype(np.float32), _np(v["batch_stats"]))
    ref = np.asarray(jax.jit(lambda p, s, a: jm.apply({"params": p, "batch_stats": s}, a,
                                                      train=False)["logits"])(
        params, stats, jnp.asarray(x)))

    exp = reference_parity_experiment(name)
    exp.data.cut = CUT
    exp.model.wav2vec2.model_name = "tiny"
    model = MazeModel(_spec(SPECS, name, layers), exp.model, device="cpu")
    assert model.trunk.block1.semantics == variant
    model.load_state_dict(state_dict_from_flax(params, stats, name), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))["logits"].numpy()
    if form == "log_softmax":
        np.testing.assert_allclose(torch.log_softmax(torch.from_numpy(got), -1).numpy(),
                                   np.asarray(jax.nn.log_softmax(ref, -1)),
                                   atol=atol, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=atol * max(1.0, float(np.abs(ref).max())))


def _reference(exp):
    exp.model.architecture.sinc_formula = "reference"
    exp.model.architecture.block_semantics = "reference"


def test_reference_semantics_train_step_matches_adfmsl():
    """maze5 under 'reference' semantics: the randomness off, both packages
    from adfmsl's init, one AdamW step on one batch."""
    _, st, _ = one_step("maze5", "float32", F32_TOL, configure=_reference, seed=4)
    assert st.model.trunk.block1.semantics == "reference"
    assert hasattr(st.model.trunk.block1, "downsample")      # the stride's 1x1 skip


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_maze_model_builds_with_its_variant(name):
    exp = reference_parity_experiment(name)
    exp.model.wav2vec2.model_name = "tiny"
    model = MazeModel(SPECS[name], exp.model, device="cpu")
    if SPECS[name].blocks:
        want = SPECS[name].block_variant or "reference"
        assert {b.semantics for b in model.trunk.children()} == {want}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, CUT)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(model(x)["logits"]).all()
