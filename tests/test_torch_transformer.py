"""The Wav2Vec2 models' sequence blocks of the port (``adfmsl_torch/models/
blocks.py``) against adfmsl's flax modules (``adfmsl/models/blocks.py``):
``AttentiveStatsPooling`` (mean || std and maze6_fmsl's raw variance),
``TransformerEncoderLayer``, ``PlainTransformerEncoder``,
``TransformerEncoderStack`` (with its ``max_len`` check) and maze8's
``ConvFMSLLayer``, each on f32 and bf16 inputs and at f32 and bf16 compute
where the module has a dtype. adfmsl's weights come across by
``flax_tree_to_state_dict``; the BatchNorms carry non-trivial running
statistics. Every output, and every layer's output of the two encoders (the
taps, by forward hooks on the port's side and flax's ``capture_intermediates``
on adfmsl's), must have flax's dtype.

Tolerances: f32 within 1e-5 * max(1, |ref|); bf16 within 3e-2 * max(1, |ref|)
(tests/test_pallas.py:185) of adfmsl's bf16 output and of its f32 output.
Eval mode throughout, plus one train-mode forward of each at dropout 0 (the
two packages' dropout streams never agree bit for bit).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.models import blocks as jb
from adfmsl_torch.models import blocks as tb
from adfmsl_torch.models.port import flax_tree_to_state_dict

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, T = 2, 9
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _stats(tree, rng):
    return jax.tree.map(
        lambda a: np.abs(rng.standard_normal(a.shape).astype(np.float32) * 0.3) + 0.2, tree)


def _case(name, dtype):
    """(adfmsl module, port module, input width) of one block at ``dtype``."""
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    if name in ("asp", "asp_var"):
        std = name == "asp"
        return (jb.AttentiveStatsPooling(24, use_std=std),
                tb.AttentiveStatsPooling(24, use_std=std), 24)
    if name == "layer":
        return (jb.TransformerEncoderLayer(32, 4, 64, 0.0, dtype=jdt),
                tb.TransformerEncoderLayer(32, 4, 64, 0.0, tdt), 32)
    if name == "plain":
        return (jb.PlainTransformerEncoder(32, 4, 2, 64, 0.0, dtype=jdt),
                tb.PlainTransformerEncoder(32, 4, 2, 64, 0.0, tdt), 32)
    if name == "stack":
        return (jb.TransformerEncoderStack(24, 32, 4, 2, 64, out_dim=24, max_len=16,
                                           dropout_rate=0.0, dtype=jdt),
                tb.TransformerEncoderStack(24, 32, 4, 2, 64, out_dim=24, max_len=16,
                                           dropout_rate=0.0, dtype=tdt), 24)
    if name == "conv_fmsl":
        return jb.ConvFMSLLayer(16, dropout=0.0), tb.ConvFMSLLayer(16, dropout_rate=0.0), 16
    raise KeyError(name)


NAMES = ["asp", "asp_var", "layer", "plain", "stack", "conv_fmsl"]
# blocks with a compute dtype run at both; the others compute in f32 whatever
# their input: (name, compute dtype, input dtype)
CASES = [(n, d, i) for n in NAMES
         for d in (("float32", "bfloat16") if n in ("layer", "plain", "stack")
                   else ("float32",))
         for i in ("float32", "bfloat16")]


def _run(name, dtype, in_dtype, train=False):
    """adfmsl's f32 and ``dtype`` outputs with their taps, and the port's."""
    rng = np.random.default_rng(sum(map(ord, name)))
    jm32, _, c = _case(name, "float32")
    x = (rng.standard_normal((B, T, c)) * 1.5).astype(np.float32)
    xj = jnp.asarray(x).astype(JDT[in_dtype])
    kw = {} if name.startswith("asp") else {"train": train}
    v = jm32.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}, xj, **kw)
    params = _np(v["params"])
    stats = _stats(_np(v["batch_stats"]), rng) if "batch_stats" in v else {}
    jm, tm, _ = _case(name, dtype)

    def ref(module):
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        mutable = ["intermediates"] + (["batch_stats"] if train and stats else [])
        out, state = module.apply(variables, xj, capture_intermediates=True, mutable=mutable,
                                  rngs={"dropout": jax.random.PRNGKey(5)}, **kw)
        inter = state["intermediates"]
        taps = [inter[f"layer{i}"]["__call__"][0] for i in range(2)] if name in (
            "plain", "stack") else []
        return out, taps
    want32, _ = ref(jm32)
    want, want_taps = ref(jm)
    tm.load_state_dict(flax_tree_to_state_dict(params, stats), strict=True)
    tm.train(train)
    taps = []
    if name in ("plain", "stack"):
        for i in range(2):
            getattr(tm, f"layer{i}").register_forward_hook(lambda m, a, o: taps.append(o))
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    with torch.no_grad():
        got = tm(xt) if name.startswith("asp") else tm(xt, torch.Generator().manual_seed(0))
    return got, taps, want, want_taps, want32


def _close(got, want, want32, dtype):
    got = got.float().numpy()
    want, want32 = np.asarray(want, np.float32), np.asarray(want32, np.float32)
    atol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want32, rtol=0, atol=atol)


@pytest.mark.parametrize("name,dtype,in_dtype", CASES, ids=["-".join(c) for c in CASES])
def test_block_matches_adfmsl(name, dtype, in_dtype):
    got, taps, want, want_taps, want32 = _run(name, dtype, in_dtype)
    assert str(got.dtype) == f"torch.{want.dtype}", (got.dtype, want.dtype)
    assert len(taps) == len(want_taps)
    for a, b in zip(taps, want_taps):
        assert str(a.dtype) == f"torch.{b.dtype}", (a.dtype, b.dtype)
    tol_dtype = "bfloat16" if "bfloat16" in (dtype, in_dtype) else "float32"
    _close(got, want, want32, tol_dtype)
    for a, b in zip(taps, want_taps):
        assert np.abs(a.float().numpy() - np.asarray(b, np.float32)).max() <= (
            TOL[tol_dtype] * max(1.0, float(np.abs(np.asarray(b, np.float32)).max())))


@pytest.mark.parametrize("name", ["layer", "stack", "conv_fmsl"])
def test_train_mode_matches_adfmsl_at_dropout_0(name):
    """Train mode with every dropout rate 0: ConvFMSL's BatchNorms take the
    batch statistics; the outputs agree as in eval."""
    got, _, want, _, want32 = _run(name, "float32", "float32", train=True)
    _close(got, want, want32, "float32")


def test_stack_refuses_a_sequence_past_max_len():
    _, tm, _ = _case("stack", "float32")
    tm.eval()
    with torch.no_grad():
        assert tm(torch.zeros((1, 16, 24))).shape == (1, 16, 24)
        with pytest.raises(ValueError, match="max_len"):
            tm(torch.zeros((1, 17, 24)))


def test_stack_pos_embedding_init_is_flax_like():
    """normal(0.02) from the generator, like flax's ``normal(0.02)``."""
    tm = tb.TransformerEncoderStack(24, 32, 4, 1, 64, max_len=1000)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    pos = tm.pos_embedding.detach()
    assert abs(float(pos.std()) - 0.02) < 1e-3 and abs(float(pos.mean())) < 1e-3
