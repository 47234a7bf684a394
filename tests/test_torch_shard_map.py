"""The port's shard-local-BN data-parallel step
(``adfmsl_torch/parallel/shard_map_step.py``) against adfmsl's
``make_shard_map_train_step`` on a 2-device mesh of the 8 virtual CPU
devices, both from adfmsl's initial weights (``state_dict_from_flax``), f32,
the randomness off, cut 4000, a global batch of 8 (4 rows a rank, two
spawned gloo ranks on the CPU, 300 s limit).

Bounds, those of ``tests/test_shard_map.py``: accuracy within 1e-6, every
parameter within 2.1 * lr + 1e-4 of adfmsl's after the step (Adam's first
step moves each weight by about lr * sign(g)); the loss here within 1e-4
relative (the file's 2e-2 covers shard-local against global BN, which both
sides share here; maze5's focal loss is near 0.08, where a loaded host's
first oneDNN calls have moved it by 2e-5), and the averaged BN running
statistics within 1e-5 * max(1, |v|). maze5 takes the external focal loss (numerator and
denominator summed over the ranks); maze4_fmsl its own integrated FMSL loss
(averaged over the ranks, with its gradients), on different label mixes.
Four local-BN steps stay finite, lower the loss and keep the ranks equal.
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.parallel import launch
import torch_rank_workers as W

CUT, BATCH = 4000, 8
MIXED = np.array([0, 0, 0, 1, 1, 0, 1, 1], np.int32)
EVEN = np.array([0, 1, 0, 1, 0, 1, 0, 1], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    x = (0.1 * np.random.default_rng(seed).standard_normal((BATCH, CUT))).astype(np.float32)
    return x, np.ones(BATCH, bool)


@pytest.mark.parametrize("name,labels", [("maze5", EVEN), ("maze4_fmsl", MIXED)],
                         ids=["maze5", "maze4_fmsl"])
def test_local_bn_step_matches_adfmsl_shard_map_step(name, labels):
    import jax

    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.parallel import make_mesh, replicate, shard_batch
    from adfmsl.parallel.shard_map_step import make_shard_map_train_step
    from test_torch_train_step import JaxRun, compare_stats

    x, m = _batch(11)
    jr = JaxRun(name, "float32")
    mesh = make_mesh(JaxMeshConfig(), devices=jax.devices()[:2])
    st = jr.state.replace(params=replicate(mesh, jr.state.params),
                          batch_stats=replicate(mesh, jr.state.batch_stats),
                          opt_state=replicate(mesh, jr.state.opt_state))
    new, met = make_shard_map_train_step(jr.exp, mesh)(
        st, *shard_batch(mesh, (x, labels, m)), jax.random.PRNGKey(7))
    pre = jr.to_port(jr.params, jr.stats)
    post = jr.to_port(new.params, new.batch_stats)

    out = launch(W.train_steps, 2, (name, pre, [(x, labels, m)], True), backend="gloo",
                 device="cpu", timeout=W.LIMIT)
    lr = jr.exp.train.optimizer.lr
    for o in out:
        assert o["replicated"] and o["skipped"] == [0.0]
        np.testing.assert_allclose(o["loss"][0], float(met["loss"]), rtol=1e-4)
        assert o["acc"][0] == pytest.approx(float(met["acc"]), abs=1e-6)
    sd = out[0]["state_dict"]
    worst = max(float((sd[k].float() - v.float()).abs().sub(1e-6 * v.float().abs()).max())
                for k, v in post.items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    assert worst <= 2.1 * lr + 1e-4, worst
    compare_stats(sd, post, 1e-5)


def test_local_bn_steps_stay_finite_and_learn():
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    exp = W.deterministic(make_experiment("maze5"))
    sd = build_model(exp.model, device="cpu", seed=0).state_dict()
    x, m = _batch(1)
    out = launch(W.train_steps, 2, ("maze5", sd, [(x, EVEN, m)] * 4, True),
                 backend="gloo", device="cpu", timeout=W.LIMIT)
    for o in out:
        assert all(np.isfinite(o["loss"])) and o["loss"][-1] < o["loss"][0]
        assert o["replicated"] and o["skipped"] == [0.0] * 4
    assert out[0]["loss"] == out[1]["loss"]
