"""One train step of the port at the models' bf16 default against adfmsl's.

The setting of test_torch_train_step.py (full width, cut 4000, batch 4,
randomness off, adfmsl's init), with the trunk in bf16 on both sides. adfmsl's
own bf16 gradients on the CPU stray far from its f32 ones (global cosine 0.91
for maze5_fmsl), so the gradients are held against the f32 gradient of the
same parameters and batch, the reference both bf16 paths approximate:

- loss within 1e-2 relative of adfmsl's bf16 loss (a few bf16 roundings);
- the global gradient: cosine to the f32 gradient at least adfmsl's bf16
  cosine minus 0.02 and at least 0.9; its norm within 10 % of the f32 norm.
  Both bf16 paths stray that far for maze4_fmsl, whose 'integrated' head
  normalises the pooled trunk features over the 4 rows of the batch
  (``proj_bn``): rows that nearly coincide make that BN amplify the trunk's
  bf16 rounding, and the gradient's scale moves with it (seen: adfmsl +2 %,
  the port +8 %, both at cosine 0.92-0.93 to f32);
- per leaf carrying 1 % or more of the global f32 norm: cosine to the f32
  gradient at least 0.85, or at least adfmsl's bf16 cosine for that leaf
  minus 0.02 where adfmsl's own is lower. The same amplification and the SE
  layers' 8 ReLU units make some leaves poor on both sides (maze4_fmsl's
  block3 SE fc1: the port 0.58, adfmsl 0.40; its first_bn bias: the port
  0.88, adfmsl 0.94);
  leaves that are analytically zero (a bias followed by a linear map and a
  train-mode BN: every block's conv1 bias, and maze5_fmsl's fc1 and FMSL
  projection biases) hold only rounding noise in bf16 and are left out;
- the global update against adfmsl's bf16 update: magnitude within 1 %,
  cosine >= 0.75 (AdamW's first step is about lr * sign(g), and in bf16 many
  more gradient coordinates sit at noise level than in f32);
- BN running statistics within 5e-3 * max(1, |v|) of adfmsl's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_step import (NAMES, batch, compare_stats, jax_run, make_train_step,
                                   port_grads, port_state)

BF16_TOL = {"loss": 1e-2, "margin": 0.02, "floor": 0.9, "leaf_floor": 0.85, "ratio": 0.1,
            "update_cos": 0.75, "update_ratio": 0.01, "stats": 5e-3}
# a bias followed by a linear map and a train-mode BN: zero gradient in exact math
ANALYTIC_ZERO = ("conv1.bias", "fc1.bias", "fmsl.proj.bias")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("name", NAMES)
def test_one_step_bf16_matches_adfmsl(name):
    tol = BF16_TOL
    x, y, m = batch(0)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)
    j32, j16 = jax_run(name, "float32"), jax_run(name, "bfloat16")
    _, g32 = j32.grad(j32.params, j32.stats, jx, jy, jm)
    _, g16 = j16.grad(j16.params, j16.stats, jx, jy, jm)
    new, jmet = j16.step(j16.state, jx, jy, jm, jax.random.PRNGKey(1))

    exp, st = port_state(j16, "bfloat16")
    pre = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    met = make_train_step(exp)(st, torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(m))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=tol["loss"])

    keys = [k for k, _ in st.model.named_parameters() if not k.endswith(ANALYTIC_ZERO)]
    ref32 = {k: v.numpy().ravel() for k, v in j32.to_port(g32, j32.stats).items()}
    ref16 = {k: v.numpy().ravel() for k, v in j16.to_port(g16, j16.stats).items()}
    got = {k: v.ravel() for k, v in port_grads(st, met).items()}
    cat = [np.concatenate([d[k] for k in keys]) for d in (got, ref16, ref32)]
    port_cos, jax_cos = _cos(cat[0], cat[2]), _cos(cat[1], cat[2])
    print(f"{name}: global gradient cosine to f32: port {port_cos:.4f}, adfmsl {jax_cos:.4f}")
    assert port_cos >= max(jax_cos - tol["margin"], tol["floor"]), (port_cos, jax_cos)
    ratio = np.linalg.norm(cat[0]) / np.linalg.norm(cat[2])
    assert abs(ratio - 1.0) <= tol["ratio"], ratio
    gnorm = np.linalg.norm(cat[2])
    checked = 0
    for k in keys:
        if np.linalg.norm(ref32[k]) < 0.01 * gnorm:
            continue
        pc, jc = _cos(got[k], ref32[k]), _cos(ref16[k], ref32[k])
        assert pc >= min(tol["leaf_floor"], jc - tol["margin"]), (k, pc, jc)
        checked += 1
    assert checked >= 10

    post = st.model.state_dict()
    ref_pre, ref_post = j16.to_port(j16.params, j16.stats), j16.to_port(new.params,
                                                                       new.batch_stats)
    dt = np.concatenate([(post[k] - pre[k]).numpy().ravel() for k in keys])
    dj = np.concatenate([(ref_post[k] - ref_pre[k]).numpy().ravel() for k in keys])
    assert _cos(dt, dj) >= tol["update_cos"], _cos(dt, dj)
    assert abs(np.linalg.norm(dt) / np.linalg.norm(dj) - 1.0) <= tol["update_ratio"]
    compare_stats(post, ref_post, tol["stats"])
