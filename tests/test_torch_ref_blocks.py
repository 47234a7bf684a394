"""The port's residual block in adfmsl's six non-'tpu' block semantics against
adfmsl's flax ``ResBlockSE`` on the same weights (``flax_tree_to_state_dict``),
and the two pooling operators those blocks add, alone.

- 'reference', 'maze2', 'maze3' (adfmsl ``models/blocks.py:270-308``),
  'fmsl_plain', 'fmsl_se' (:151-184) and 'fmsl_adaptive' (:186-221), each at
  stride 1 and 2 (and 3 for the stack head), with and without a channel change
  (at stride 2, and at stride 1 as the stack head), as a stack head
  (``first``) and not, at length 8 or 13 (each form and each shape meets
  both):
  the eval output in f32 within 1e-5 * max|y|; the train-mode output (dropout
  0, BN on the batch statistics) and ``jax.grad`` against autograd for the
  input and every parameter, of the same random projection of the output,
  within 1e-4 * max of the leaf; a leaf whose largest gradient is under 1 % of
  the block's largest (the SE gate's fc2 at one hidden unit; a conv bias
  feeding a train-mode BN, analytically zero) within 1e-4 * 1 % of that, as
  tests/test_torch_train_step.py sets its small leaves apart by 1 % of the
  norm: their few elements sum terms that cancel, and keep f32's rounding of
  the large ones.
- One bf16 case a form, at ``tests/test_pallas.py:55``'s bf16 tolerance
  (rtol 2e-2, atol 2e-2 * max): the output's dtype must be adfmsl's, which
  holds only if the non-'tpu' BatchNorms return f32 (they take no dtype in
  adfmsl) where the pre-activation reaches the sum.
- The overlap pool ``AvgPool(2s-1, s, pad s-1)`` counting its pads at both
  edges (flax ``avg_pool``) and ``adaptive_avg_resample`` against adfmsl's
  ``_adaptive_avg_resample`` (:92-112; floor / ceil bins, the two-element
  blend), forward and gradient, at lengths 7, 13 and 21 with s 2 and 3.
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from adfmsl.models import blocks as jax_blocks
from adfmsl_torch.models.blocks import (ResBlockSE, adaptive_avg_resample,
                                       overlap_avg_pool)
from adfmsl_torch.models.port import flax_tree_to_state_dict

SEMANTICS = ["reference", "maze2", "maze3", "fmsl_plain", "fmsl_se", "fmsl_adaptive"]
# (cin, cout, stride, first)
SHAPES = [(16, 16, 1, False), (16, 16, 2, False), (16, 32, 2, False), (16, 32, 1, True),
          (16, 16, 3, True)]
LENGTHS = (8, 13)
BATCH = 3


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _pair(semantics, cin, cout, stride, first, rng, dtype=jnp.float32):
    """adfmsl's block with its variables (BN statistics drawn at random) and
    the port's block loaded with them."""
    jb = jax_blocks.ResBlockSE(cin, cout, stride, 0.0, first=first, use_se=True,
                               semantics=semantics, dtype=dtype)
    v = jb.init(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                jnp.zeros((BATCH, 13, cin), jnp.float32))
    params = _np(v["params"])
    stats = jax.tree.map(lambda a: (np.abs(rng.standard_normal(a.shape)) + 0.1)
                         .astype(np.float32), _np(v["batch_stats"]))
    tb = ResBlockSE(cin, cout, stride, 0.0, first=first, use_se=True, semantics=semantics,
                    dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tb.load_state_dict(flax_tree_to_state_dict(params, stats), strict=True)
    return jb, params, stats, tb


@pytest.mark.parametrize("cin,cout,stride,first", SHAPES)
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_block_matches_adfmsl(semantics, cin, cout, stride, first):
    i, j = SEMANTICS.index(semantics), SHAPES.index((cin, cout, stride, first))
    rng = np.random.default_rng(100 * i + j)
    jb, params, stats, tb = _pair(semantics, cin, cout, stride, first, rng)
    # one length a case, so that each form and each shape meets an even and an
    # odd one (adfmsl's eager ops compile for every new shape)
    for t in (LENGTHS[(i + j) % 2],):
        x = rng.standard_normal((BATCH, t, cin)).astype(np.float32)
        # eval
        y = np.asarray(jb.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
        tb.eval()
        with torch.no_grad():
            got = tb(torch.from_numpy(x)).numpy()
        assert got.shape == y.shape, (got.shape, y.shape)
        np.testing.assert_allclose(got, y, rtol=0, atol=1e-5 * np.abs(y).max())

        # train: BN on the batch statistics, dropout 0; a random projection's gradients
        r = rng.standard_normal(y.shape).astype(np.float32)

        def loss(p, xx):
            out, _ = jb.apply({"params": p, "batch_stats": stats}, xx, train=True,
                              mutable=["batch_stats"])
            return jnp.sum(out * r), out

        (_, y_tr), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        tb.train()
        tx = torch.from_numpy(x).requires_grad_(True)
        out = tb(tx)
        (out * torch.from_numpy(r)).sum().backward()
        y_tr = np.asarray(y_tr)
        np.testing.assert_allclose(out.detach().numpy(), y_tr, rtol=0,
                                   atol=1e-4 * np.abs(y_tr).max())
        gx = np.asarray(gx)
        np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=0, atol=1e-4 * np.abs(gx).max())
        ref = {k: v.numpy() for k, v in flax_tree_to_state_dict(_np(gp), {}).items()}
        gmax = max(np.abs(g).max() for g in ref.values())
        for name, p in tb.named_parameters():
            g = ref[name]
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                       atol=1e-4 * max(np.abs(g).max(), 1e-2 * gmax),
                                       err_msg=f"{semantics} t={t} {name}")
            p.grad = None


# one bf16 case a form, chosen so that the pre-activation reaches the sum
# unconvolved where the form allows it (fmsl_plain / fmsl_se: no 1x1 skip at
# stride 1 without a channel change)
BF16_CASE = {"reference": (16, 32, 2, False), "maze2": (16, 16, 2, False),
             "maze3": (16, 32, 2, False), "fmsl_plain": (16, 16, 1, False),
             "fmsl_se": (16, 16, 1, False), "fmsl_adaptive": (16, 16, 2, False)}
BF16_LENGTH = 13


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_block_bf16_matches_adfmsl(semantics):
    rng = np.random.default_rng(7)
    cin, cout, stride, first = BF16_CASE[semantics]
    jb, params, stats, tb = _pair(semantics, cin, cout, stride, first, rng, jnp.bfloat16)
    x = rng.standard_normal((BATCH, BF16_LENGTH, cin)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)          # the trunk's dtype, as in a model
    y = jb.apply({"params": params, "batch_stats": stats}, xb)
    tb.eval()
    with torch.no_grad():
        got = tb(torch.from_numpy(x).to(torch.bfloat16))
    want_dtype = {jnp.dtype(jnp.float32): torch.float32,
                  jnp.dtype(jnp.bfloat16): torch.bfloat16}[y.dtype]
    assert got.dtype == want_dtype, (got.dtype, y.dtype)
    y = np.asarray(y, dtype=np.float32)
    np.testing.assert_allclose(got.float().numpy(), y, rtol=2e-2,
                               atol=2e-2 * np.abs(y).max())


@pytest.mark.parametrize("stride", [2, 3])
@pytest.mark.parametrize("length", [7, 13, 21])
def test_overlap_pool_counts_pads_like_flax(length, stride):
    """Both edges' windows hold s - 1 pads, and the mean divides by 2s - 1."""
    rng = np.random.default_rng(length * 10 + stride)
    x = rng.standard_normal((2, length, 5)).astype(np.float32)
    k, pad = 2 * stride - 1, stride - 1

    def pool(a):
        return fnn.avg_pool(a, (k,), strides=(stride,), padding=((pad, pad),))

    y, vjp = jax.vjp(pool, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = overlap_avg_pool(tx, stride)
    assert got.shape == y.shape == (2, -(-length // stride), 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=1e-6)
    # the first window: s real samples over 2s - 1
    np.testing.assert_allclose(got[:, 0].detach().numpy(),
                               x[:, :stride].sum(axis=1) / k, rtol=1e-6)
    r = rng.standard_normal(y.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(r))
    got.backward(torch.from_numpy(r))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride", [2, 3])
@pytest.mark.parametrize("length", [7, 13, 21])
def test_adaptive_resample_matches_adfmsl(length, stride):
    """ceil(L/s) pooled samples back up to L: floor / ceil bin edges, one- and
    two-element bins; f32 out for a bf16 input (adfmsl's f32 blend weights)."""
    rng = np.random.default_rng(length * 10 + stride + 1)
    lin = -(-length // stride)
    x = rng.standard_normal((2, lin, 5)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jax_blocks._adaptive_avg_resample(a, length), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = adaptive_avg_resample(tx, length)
    assert got.shape == y.shape == (2, length, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=1e-6)
    r = rng.standard_normal(y.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(r))
    got.backward(torch.from_numpy(r))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-6)
    yb = jax_blocks._adaptive_avg_resample(jnp.asarray(x).astype(jnp.bfloat16), length)
    gb = adaptive_avg_resample(torch.from_numpy(x).to(torch.bfloat16), length)
    assert yb.dtype == jnp.float32 and gb.dtype == torch.float32
    np.testing.assert_array_equal(gb.numpy(), np.asarray(yb))
    assert adaptive_avg_resample(tx, lin) is tx
