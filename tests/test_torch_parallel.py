"""The port's mesh, launcher and data-parallel (global-batch) train step
against adfmsl's mesh paths (``adfmsl/parallel/mesh.py``, the GSPMD step of
``adfmsl/train/steps.py`` under a 2-device mesh of the 8 virtual CPU devices).

The port's ranks are spawned gloo processes on the CPU
(``adfmsl_torch.parallel.launch``, one torch thread each, a 300 s limit each);
their rank functions live in ``tests/torch_rank_workers.py``, which imports
no JAX, and the comparisons run here.

- ``mesh_shape`` / ``make_mesh``: adfmsl's (dp, mp) arithmetic and error; on
  4 ranks a 2 x 2 mesh puts rank r at (r // 2, r % 2), the layout of
  adfmsl's device array, with its column as data group and its row as model
  group.
- ``pad_batch_to_devices`` equals adfmsl's; the loader's ``shard_index`` /
  ``num_shards`` ids equal adfmsl's; its ``rank`` / ``world`` blocks put
  together are the one-process batches (shuffled, a batch of 5 on 2 ranks).
- One step of maze5 (focal CE), maze5_fmsl (weighted CE [0.3, 0.7]) and
  maze4_fmsl (the integrated FMSL loss) on a global batch of 8, 4 rows a
  rank, maze5_fmsl and maze4_fmsl with different label mixes on the two
  ranks (3 spoof + 1 bonafide against 1 + 3): loss, per-leaf gradient and
  global update against adfmsl's mesh step: the loss within 1e-4 relative
  (``tests/test_train_parity.py`` holds 5e-4; a loaded host's first oneDNN
  calls move a focal loss near 0.05 by 2e-5), gradients and update at
  ``tests/test_torch_train_step.py``'s f32 tolerances (gradient cosine 0.999,
  update cosine 0.99); the two ranks' parameters bitwise equal. At one rank
  the step is the plain step bit for bit.
- The launcher: ``nccl`` with more ranks than cards raises and names
  ``gloo``; a rank that raises fails the launch with its traceback; a hung
  collective fails it at its time limit, or, with no time limit, at the
  collective's own.
"""
import time

import numpy as np
import pytest
import torch

from adfmsl_torch.config import MeshConfig
from adfmsl_torch.parallel import launch, make_mesh, mesh_shape, pad_batch_to_devices
from adfmsl_torch.parallel.launch import RankFailed
import torch_rank_workers as W

CUT, BATCH = 4000, 8


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(fn, n, *args, timeout=W.LIMIT):
    return launch(fn, n, args, backend="gloo", device="cpu", timeout=timeout)


def test_make_mesh_shapes_errors_and_groups():
    import jax

    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.parallel import make_mesh as jax_make_mesh

    for dp, mp in ((-1, 1), (4, 2), (2, 4), (8, 1)):
        ref = jax_make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp))
        assert mesh_shape(MeshConfig(data_parallel=dp, model_parallel=mp), 8) == \
            ref.devices.shape
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        jax_make_mesh(JaxMeshConfig(data_parallel=3, model_parallel=2))
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        make_mesh(MeshConfig(data_parallel=3, model_parallel=2), world=8)
    ref = jax_make_mesh(JaxMeshConfig(data_parallel=2, model_parallel=2),
                        devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    out = run(W.mesh_layout, 4, MeshConfig(data_parallel=2, model_parallel=2))
    for r, o in enumerate(out):
        d, m = o["data_rank"], o["model_rank"]
        assert (o["dp"], o["mp"]) == (2, 2) and ids[d, m] - ids[0, 0] == r
        assert o["data_group"] == [m, 2 + m] and o["model_group"] == [2 * d, 2 * d + 1]


def test_pad_batch_to_devices_matches_adfmsl():
    from adfmsl.parallel import pad_batch_to_devices as jax_pad

    args = (np.arange(20, dtype=np.float32).reshape(5, 4), np.arange(5, dtype=np.int32),
            np.ones(5, bool))
    for n in (1, 2, 5, 8):
        for got, ref in zip(pad_batch_to_devices(*args, n), jax_pad(*args, n)):
            np.testing.assert_array_equal(got, ref)


def test_loader_shards_and_row_blocks(fixture_dir):
    from adfmsl.data import AsvspoofDataset as JaxDataset
    from adfmsl.data import DataLoader as JaxLoader
    from adfmsl.data import parse_protocol as jax_parse

    from adfmsl_torch.data import AsvspoofDataset, DataLoader, parse_protocol

    tr = fixture_dir["train"]
    proto = parse_protocol(tr["protocol"])
    ds = AsvspoofDataset(proto, tr["audio_dir"], cut=CUT)
    jds = JaxDataset(jax_parse(tr["protocol"]), tr["audio_dir"], cut=CUT)
    for n in (2, 5, 7):
        for i in range(n):
            assert (DataLoader(ds, 4, shard_index=i, num_shards=n).ids
                    == JaxLoader(jds, 4, shard_index=i, num_shards=n).ids)
    whole = list(DataLoader(ds, 5, shuffle=True, seed=3, prefetch=0))
    blocks = [list(DataLoader(ds, 5, shuffle=True, seed=3, prefetch=2, rank=r, world=2))
              for r in range(2)]
    assert len(whole) == len(blocks[0]) == len(blocks[1]) == -(-len(proto) // 5)
    for b, b0, b1 in zip(whole, *blocks):
        assert b0.global_ids == b1.global_ids == b.utt_ids + [""] * (6 - len(b.utt_ids))
        assert b0.utt_ids + b1.utt_ids == b0.global_ids
        np.testing.assert_array_equal(np.concatenate([b0.audio, b1.audio])[:5], b.audio)
        np.testing.assert_array_equal(np.concatenate([b0.mask, b1.mask])[:5], b.mask)
        np.testing.assert_array_equal(np.concatenate([b0.label, b1.label])[:5], b.label)
        assert not np.concatenate([b0.mask, b1.mask])[5:].any()


# global batch of 8: ranks 0 / 1 hold rows 0-3 / 4-7
MIXED = np.array([0, 0, 0, 1, 1, 0, 1, 1], np.int32)      # 3 + 1 spoof against 1 + 3
EVEN = np.array([0, 1, 0, 1, 0, 1, 0, 1], np.int32)
DP_CASES = [("maze5", EVEN), ("maze5_fmsl", MIXED), ("maze4_fmsl", MIXED)]


def jax_mesh_step(name, x, y, m):
    """adfmsl's model, its GSPMD step on a 2-device mesh, and its gradient of
    the same loss; returns (port state dict before, after, gradients by name,
    loss, acc)."""
    import jax
    import jax.numpy as jnp

    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.parallel import make_mesh as jax_make_mesh
    from adfmsl.parallel import replicate, shard_batch
    from test_torch_train_step import JaxRun

    jr = JaxRun(name, "float32")
    mesh = jax_make_mesh(JaxMeshConfig(), devices=jax.devices()[:2])
    st = jr.state.replace(params=replicate(mesh, jr.state.params),
                          batch_stats=replicate(mesh, jr.state.batch_stats),
                          opt_state=replicate(mesh, jr.state.opt_state))
    xs, ys, ms = shard_batch(mesh, (x, y, m))
    with mesh:
        new, met = jr.step(st, xs, ys, ms, jax.random.PRNGKey(1))
    _, g = jr.grad(jr.params, jr.stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    grads = {k: v.numpy() for k, v in jr.to_port(g, jr.stats).items()
             if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    return (jr.to_port(jr.params, jr.stats), jr.to_port(new.params, new.batch_stats),
            grads, float(met["loss"]), float(met["acc"]))


@pytest.mark.parametrize("name,labels", DP_CASES, ids=[c[0] for c in DP_CASES])
def test_dp_step_matches_adfmsl_mesh_step(name, labels):
    from test_torch_train_step import F32_TOL, compare_grads, compare_stats, compare_updates

    x = (0.1 * np.random.default_rng(5).standard_normal((BATCH, CUT))).astype(np.float32)
    m = np.ones(BATCH, bool)
    pre, post, grads, loss, acc = jax_mesh_step(name, x, labels, m)
    out = run(W.train_steps, 2, name, pre, [(x, labels, m)])
    for o in out:
        np.testing.assert_allclose(o["loss"][0], loss, rtol=1e-4)
        assert o["acc"][0] == pytest.approx(acc, abs=1e-6) and o["skipped"] == [0.0]
        assert o["replicated"]
    assert out[0]["loss"] == out[1]["loss"]
    for k in out[0]["state_dict"]:
        assert torch.equal(out[0]["state_dict"][k], out[1]["state_dict"][k]), k
    compare_grads({k: v.numpy() for k, v in out[0]["grads"].items()}, grads, F32_TOL)
    compare_updates(pre, out[0]["state_dict"], pre, post, F32_TOL)
    compare_stats(out[0]["state_dict"], post, F32_TOL["stats"])


def test_one_rank_step_is_the_plain_step():
    """A world of one: the data-parallel step (its all_reduces the identity)
    gives the plain step's loss, parameters and BN statistics bit for bit."""
    out = run(W.one_rank_equals_plain, 1, "maze5_fmsl")
    assert out[0]["loss_equal"] and out[0]["state_equal"], out[0]


def test_nccl_with_more_ranks_than_cards_names_gloo(monkeypatch):
    with pytest.raises(ValueError, match="gloo"):
        launch(W.raise_on_rank, 2, (0,), backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks, 1 visible.*'gloo'"):
        launch(W.raise_on_rank, 2, (0,), backend="nccl", device="cuda")


def test_a_failed_or_hung_rank_fails_the_launch():
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        run(W.raise_on_rank, 2, 1)
    with pytest.raises((TimeoutError, RankFailed)):   # the launcher's or gloo's limit
        run(W.hang, 2, timeout=10.0)


def test_without_a_time_limit_a_hung_collective_fails_the_launch():
    """The CLIs' launches have no time limit (a training run may take days):
    there the collective's own limit fails the waiting rank, and that rank
    fails the launch (rank 0, asleep, is killed)."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 of 2"):
        launch(W.hang, 2, backend="gloo", device="cpu", timeout=None, collective_timeout=5.0)
    assert time.monotonic() - t0 < W.LIMIT
