"""The parts of the port's training path against adfmsl's: losses, schedules,
optimizer chains, the plateau tracker and early stopper, checkpoint
retention, and the statistics of the random masks (dropout, SpecAugment),
whose bits cannot match JAX's.

Tolerances: losses within 1e-6 relative (f32, the same formulas); schedules
within 1e-6 of the peak learning rate (optax evaluates them in f32, the port
in double; near the end of a cosine the f32 cosine of an angle close to pi is
off by about 1e-6 relative); optimizer chains within
1e-6 relative after 5 steps on a small tree (f32).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl_torch.config import OptimizerConfig, make_experiment
from adfmsl_torch.heads import losses as L
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.ops.specaugment import spec_augment
from adfmsl_torch.train import (CheckpointManager, EarlyStopper, Optimizer, PlateauTracker,
                                TrainState, make_schedule)


def _logits_labels(seed=0, n=9):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((n, 2))).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    return logits, labels, mask


@pytest.mark.parametrize("name,weights", [("ce", None), ("weighted_ce", [0.1, 0.9]),
                                          ("weighted_ce", [0.3, 0.7]), ("focal_ce", None),
                                          ("focal_bce", None), ("fmsl", None)])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_compute_loss_matches_adfmsl(name, weights, masked):
    from adfmsl.heads import losses as JL

    logits, labels, mask = _logits_labels(1)
    m = mask if masked else None
    alpha = 1.0 if name == "focal_bce" else 0.25
    ref = JL.compute_loss(name, jnp.asarray(logits), jnp.asarray(labels),
                          class_weights=weights, focal_alpha=alpha,
                          mask=None if m is None else jnp.asarray(m))
    got = L.compute_loss(name, torch.from_numpy(logits), torch.from_numpy(labels),
                         class_weights=weights, focal_alpha=alpha,
                         mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_loss_pieces_match_adfmsl():
    from adfmsl.heads import losses as JL

    logits, labels, mask = _logits_labels(2)
    jl, jy, jm = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)
    tl, ty, tm = torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask)
    pairs = [(JL.cross_entropy(jl, jy, [0.1, 0.9]), L.cross_entropy(tl, ty, [0.1, 0.9])),
             (JL.focal_ce(jl, jy), L.focal_ce(tl, ty)),
             (JL.focal_bce(jl, jy), L.focal_bce(tl, ty)),
             (JL.masked_mean(jl[:, 0], jm), L.masked_mean(tl[:, 0], tm)),
             (JL.masked_mean(jl[:, 0], jnp.zeros_like(jm)),          # max(sum m, 1)
              L.masked_mean(tl[:, 0], torch.zeros_like(tm)))]
    pairs += list(zip(JL.loss_parts("weighted_ce", jl, jy, class_weights=[0.3, 0.7], mask=jm),
                      L.loss_parts("weighted_ce", tl, ty, class_weights=[0.3, 0.7], mask=tm)))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def _opt_cfg(**kw):
    return OptimizerConfig(**kw)


@pytest.mark.parametrize("kw", [dict(scheduler="constant"),
                                dict(scheduler="cosine", min_lr=1e-7),
                                dict(scheduler="cosine"),
                                dict(scheduler="step", step_size=2, step_gamma=0.5),
                                dict(scheduler="warmup_cosine", warmup_steps=7),
                                dict(scheduler="plateau")],
                         ids=["constant", "cosine_min", "cosine", "step", "warmup", "plateau"])
def test_schedules_match_optax(kw):
    from adfmsl.config.base import OptimizerConfig as JaxOptimizerConfig
    from adfmsl.train.optim import make_schedule as jax_make_schedule

    cfg = _opt_cfg(lr=3e-4, **kw)
    jsched = jax_make_schedule(JaxOptimizerConfig(**dataclasses.asdict(cfg)), 5, 6)
    sched = make_schedule(cfg, 5, 6)
    for count in range(40):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=0,
                                   atol=1e-6 * cfg.lr, err_msg=f"count {count}")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"w": rng.standard_normal(5).astype(np.float32),
                  "z": rng.standard_normal(2).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["noclip", "clip"])
def test_optimizer_chain_matches_optax(name, clip):
    """Five updates from random gradients (one leaf with a zero gradient: optax
    still moves it by the decay and the moments) on a small tree, with a
    cosine schedule, against adfmsl's ``make_optimizer`` chain."""
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.train.optim import make_optimizer as jax_make_optimizer

    jexp = jax_experiment("maze5")
    o = jexp.train.optimizer
    o.name, o.lr, o.weight_decay, o.grad_clip_norm = name, 1e-2, 1e-2, clip
    o.scheduler, o.momentum = "cosine", 0.9
    jexp.train.num_epochs = 2
    tx, _ = jax_make_optimizer(jexp, 4)
    params = jax.tree.map(jnp.asarray, _tree(0))
    opt_state = tx.init(params)
    flat = [("a", ("a",)), ("b.w", ("b", "w")), ("b.z", ("b", "z"))]
    tparams = [torch.nn.Parameter(torch.from_numpy(_tree(0)[p[0]] if len(p) == 1
                                                   else _tree(0)[p[0]][p[1]]))
               for _, p in flat]
    opt = Optimizer(OptimizerConfig(**dataclasses.asdict(o)), tparams, 4, 2)
    for step in range(5):
        g = _tree(100 + step)
        g["b"]["z"] = np.zeros(2, np.float32)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        grads = [torch.from_numpy(g[p[0]] if len(p) == 1 else g[p[0]][p[1]]) for _, p in flat]
        for p, gr in zip(tparams, grads):
            p.grad = gr.clone()
        norm = torch.sqrt(sum((gr * gr).sum() for gr in grads))
        opt.clip_(norm)
        opt.step()
    for (_, path), p in zip(flat, tparams):
        ref = params[path[0]] if len(path) == 1 else params[path[0]][path[1]]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
    assert opt.count == 5


def test_plateau_tracker_and_early_stopper_match_adfmsl():
    from adfmsl.train.early_stop import EarlyStopper as JaxEarlyStopper
    from adfmsl.train.optim import PlateauTracker as JaxPlateauTracker

    seq = [0.5, 0.4, 0.45, 0.41, 0.42, 0.43, 0.39, 0.39, 0.4, 0.5, 0.6, 0.1]
    for mode in ("min", "max"):
        a, b = PlateauTracker(2, 0.5, mode, 0.005), JaxPlateauTracker(2, 0.5, mode, 0.005)
        assert [a.update(v) for v in seq] == [b.update(v) for v in seq]
        a, b = EarlyStopper(3, 0.01, mode), JaxEarlyStopper(3, 0.01, mode)
        assert [a.step(v) for v in seq] == [b.step(v) for v in seq]
    with pytest.raises(ValueError):
        EarlyStopper(mode="up")


def test_checkpoint_retention_matches_adfmsl_rule(tmp_path):
    """Best-k retention: the best ``keep_best_k`` by dev accuracy; NaN ranks
    worst with the newest NaN epoch first among those; ties keep the newest;
    restore reads the latest retained epoch; ``load_checkpoint`` on the
    directory reads that epoch's model."""
    from adfmsl_torch.models import build_model, load_checkpoint

    exp = make_experiment("maze5")
    exp.train.keep_best_k = 2
    model = build_model(exp.model, device="cpu", seed=0)
    opt = Optimizer(exp.train.optimizer, model.parameters(), 4, 5)
    state = TrainState(model, opt, seed=0)
    mgr = CheckpointManager(str(tmp_path), keep_best_k=2)
    accs = [0.5, float("nan"), 0.7, 0.5, 0.7, float("nan")]
    kept = []
    for epoch, acc in enumerate(accs):
        state.step = 10 * epoch
        mgr.save(epoch, exp, state, {"dev_acc": acc})
        kept.append(mgr.all_epochs())
    assert kept == [[0], [0, 1], [0, 2], [2, 3], [2, 4], [2, 4]]
    assert mgr.best_epoch() == 4
    state.step = -1
    _, epoch = mgr.restore(state)
    assert epoch == 4 and state.step == 40
    cfg, sd = load_checkpoint(str(tmp_path))
    assert cfg.model.name == "maze5" and set(sd) == set(model.state_dict())
    none_kept = CheckpointManager(str(tmp_path / "nodev"), keep_best_k=1)
    for epoch in range(3):
        none_kept.save(epoch, exp, state, {"dev_acc": float("nan")})
    assert none_kept.all_epochs() == [2]
    # adfmsl keeps max(keep_best_k, keep_last) with keep_last 1: k = 0 keeps one
    zero = CheckpointManager(str(tmp_path / "zero"), keep_best_k=0)
    for epoch, acc in enumerate([0.7, 0.5]):
        zero.save(epoch, exp, state, {"dev_acc": acc})
    assert zero.all_epochs() == [0]


def test_dropout_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = dropout(x, 0.3, g, train=True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.005                      # 200k draws: 5 sigma ~ 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    assert dropout(x, 0.3, None, train=False) is x
    assert dropout(x, 0.0, None, train=True) is x
    assert torch.equal(dropout(x, 1.0, g, train=True), torch.zeros_like(x))
    with pytest.raises(ValueError):
        dropout(x, 0.3, None, train=True)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(dropout(x, 0.3, g1, True), dropout(x, 0.3, g2, True))


def _mask_runs(row):
    """Start and end of each run of zeros in a 1-D {0,1} array."""
    z = np.concatenate([[0], (row == 0).astype(int), [0]])
    d = np.diff(z)
    return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)))


@pytest.mark.parametrize("semantics", ["torchaudio", "reference_handrolled"])
def test_specaugment_statistics(semantics):
    """One frequency and one time mask per sample on ones: widths within
    their semantics' ranges, masks drawn per sample, channels_last equal to
    the transposed layout."""
    b, c, t, param = 256, 40, 60, 10
    x = torch.ones(b, c, t)
    g = torch.Generator().manual_seed(1)
    y = spec_augment(x, g, param, param, 1, 1, semantics).numpy()
    fmask, tmask = y.max(axis=2), y.max(axis=1)          # (B, C), (B, T)
    widths = []
    for mrow, size in [(r, c) for r in fmask] + [(r, t) for r in tmask]:
        runs = _mask_runs(mrow)
        assert len(runs) <= 1
        start, end = runs[0] if runs else (0, 0)
        widths.append(end - start)
        if semantics == "torchaudio":
            assert end - start < param
        elif runs:
            assert start < param and end <= size
    widths = np.array(widths)
    assert len(set(map(tuple, fmask))) > b // 4           # per-sample draws
    if semantics == "torchaudio":
        assert widths.max() == param - 1 and abs(widths.mean() - (param - 1) / 2) < 0.6
    else:
        assert widths.max() > param                       # may span most of the axis
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    xr = torch.rand(4, c, t, generator=torch.Generator().manual_seed(3))
    a = spec_augment(xr, g1, param, param, 2, 2, semantics)
    bl = spec_augment(xr.transpose(1, 2), g2, param, param, 2, 2, semantics,
                      channels_last=True)
    assert torch.equal(a, bl.transpose(1, 2))


def test_randomness_stays_out_of_eval():
    """At eval, dropout, SpecAugment and LSA draw nothing: the forward does
    not need or touch the generators, and is deterministic."""
    from adfmsl_torch.models import build_model

    exp = make_experiment("maze5_fmsl")
    exp.data.cut = 4000
    exp.model.fmsl.enable_lsa = True
    model = build_model(exp.model, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32))
    with torch.inference_mode():
        a, b = model(x)["logits"], model(x)["logits"]
    assert torch.equal(a, b)
    model.train()
    with pytest.raises((KeyError, ValueError)):
        model(x)                                      # train mode needs its streams
