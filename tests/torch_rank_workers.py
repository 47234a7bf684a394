"""Rank functions of the port's multi-device tests, run by
``adfmsl_torch.parallel.launch`` in spawned gloo ranks on the CPU.

A spawned rank imports this module by name, so it imports torch, numpy and
``adfmsl_torch`` only (the tests compare against adfmsl in the parent
process). Each function takes the rank's device first and returns what the
parent compares: losses, unclipped gradients, state dicts, scores.
"""
import functools

import numpy as np
import torch
import torch.distributed as dist

from adfmsl_torch.config import MeshConfig, make_experiment
from adfmsl_torch.models import build_model
from adfmsl_torch.parallel import check_replicated, make_mesh, replicate, shard_batch
from adfmsl_torch.train import Optimizer, TrainState, make_train_step


LIMIT = 300.0        # seconds a launch of these functions may take before it fails


def rank_fn(fn):
    """A rank function: it runs on one torch thread. The suite runs several
    workers, each with its ranks, on the machine's cores, and on a loaded host
    a rank's thread pool does not always get the threads it asked for, which
    moves the rounding of its CPU convolutions (by 1e-5 relative, seen)."""
    @functools.wraps(fn)
    def run(dev, *args):
        torch.set_num_threads(1)
        return fn(dev, *args)
    return run


def deterministic(exp, dtype="float32", cut=4000):
    """The randomness off (dropout, SpecAugment, LSA), at ``dtype`` and ``cut``."""
    exp.data.cut = cut
    exp.model.dtype = dtype
    exp.model.architecture.dropout_rate = 0.0
    exp.model.architecture.fc_dropout = 0.0
    exp.model.spec_augment.enabled = False
    if exp.model.fmsl is not None:
        exp.model.fmsl.proj_dropout = 0.0
        exp.model.fmsl.enable_lsa = False
    return exp


def unclipped_grads(state, metrics):
    """The step's gradients by name before the clip (``.grad`` holds them
    scaled by min(1, clip / norm))."""
    clip = state.optimizer.clip
    norm = float(metrics["grad_norm"])
    factor = clip / norm if clip and norm >= clip else 1.0
    return {n: p.grad.detach().float().clone() / factor
            for n, p in state.model.named_parameters()}


@rank_fn
def train_steps(dev, name, sd, batches, local_bn=False, steps_per_epoch=10,
                cfg=None, world_mesh=None):
    """``len(batches)`` data-parallel steps of ``name`` from the state dict
    ``sd``; each (audio, labels, mask) is the global batch, of which this rank
    takes its rows. Returns each step's loss, acc, grad norm and first-step
    gradients, the final state dict, and whether the ranks' parameters stayed
    equal."""
    from adfmsl_torch.parallel.shard_map_step import make_shard_map_train_step

    exp = deterministic(make_experiment(name))
    if cfg:
        cfg(exp)
    mesh = make_mesh(world_mesh or MeshConfig())
    model = build_model(exp.model, device=dev)
    model.load_state_dict(sd, strict=True)
    replicate(mesh, model)
    st = TrainState(model, Optimizer.for_model(exp, model, steps_per_epoch), seed=0)
    step = (make_shard_map_train_step(exp, mesh) if local_bn
            else make_train_step(exp, mesh))
    keys = ("loss", "acc", "grad_norm", "skipped")
    out = {k: [] for k in keys}
    for i, (a, y, m) in enumerate(batches):
        a, y, m = shard_batch(mesh, [torch.from_numpy(a), torch.from_numpy(y).long(),
                                     torch.from_numpy(m)])
        met = step(st, a, y, m, st.generators(0, i, mesh.data_rank))
        for k in keys:
            out[k].append(float(met[k]))
        if i == 0:
            out["grads"] = unclipped_grads(st, met)
    out["state_dict"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        check_replicated(model)
        out["replicated"] = True
    except RuntimeError:
        out["replicated"] = False
    return out


@rank_fn
def mesh_scores(dev, name, dtype, sd, protocol, audio_dir, cut, batch_size, score_path):
    """Score a protocol through ``evaluate_to_file(mesh=...)`` from a loader
    of this rank's rows."""
    from adfmsl_torch.data import AsvspoofDataset, DataLoader, parse_protocol
    from adfmsl_torch.evaluation import evaluate_to_file

    exp = make_experiment(name)
    exp.model.dtype = dtype
    mesh = make_mesh(MeshConfig())
    model = build_model(exp.model, device=dev)
    model.load_state_dict(sd, strict=True)
    replicate(mesh, model)
    model.eval()
    proto = parse_protocol(protocol)
    loader = DataLoader(AsvspoofDataset(proto, audio_dir, cut=cut), batch_size,
                        shuffle=False, drop_last=False, rank=mesh.data_rank, world=mesh.dp)
    res = evaluate_to_file(model, loader, score_path, labels=proto.labels, mesh=mesh)
    return {"utt_ids": res.utt_ids, "scores": res.scores, "metrics": res.metrics}


@rank_fn
def dp_fit(dev, name, fixture, cut, batch_size, epochs, checkpoint_dir, sd=None,
           drop_last=True):
    """``Trainer(mesh=...).fit`` over the fixture's train split (dev split:
    batches of 5 rows, padded on the ranks), from ``sd`` when given. Returns
    the history, or the message of the error ``fit`` raised."""
    from adfmsl_torch.data import parse_protocol
    from adfmsl_torch.train import Trainer, make_dataset_and_loader

    exp = deterministic(make_experiment(name), cut=cut)
    exp.train.batch_size = batch_size
    exp.train.num_epochs = epochs
    exp.data.prefetch = 0
    mesh = make_mesh(MeshConfig())
    shard = {"rank": mesh.data_rank, "world": mesh.dp}
    tp = parse_protocol(fixture["train"]["protocol"])
    dpr = parse_protocol(fixture["dev"]["protocol"])
    train = make_dataset_and_loader(exp, tp, fixture["train"]["audio_dir"], shuffle=True,
                                    drop_last=drop_last, **shard)
    devl = make_dataset_and_loader(exp, dpr, fixture["dev"]["audio_dir"], shuffle=False,
                                   batch_size=5, drop_last=False, **shard)
    tr = Trainer(exp, train, devl, checkpoint_dir=checkpoint_dir, mesh=mesh, device=dev)
    if sd is not None:
        tr.state.model.load_state_dict(sd, strict=True)
    try:
        hist = tr.fit()
    except ValueError as e:
        return {"error": str(e)}
    check_replicated(tr.state.model)
    return {"history": [(h.train_loss, h.train_acc, h.dev_acc, h.dev_eer) for h in hist],
            "state_dict": {k: v.detach().clone()
                           for k, v in tr.state.model.state_dict().items()}}


@rank_fn
def fewshot_fit(dev, fixture_train, sd, fcfg, cut):
    """``FewshotTrainer(mesh=...).fit`` of maze5 from ``sd``; the history and
    the final state dict."""
    from adfmsl_torch.data import AsvspoofDataset, parse_protocol
    from adfmsl_torch.train import FewshotConfig, FewshotTrainer

    exp = deterministic(make_experiment("maze5"), cut=cut)
    mesh = make_mesh(MeshConfig())
    proto = parse_protocol(fixture_train["protocol"])
    tr = FewshotTrainer(exp, FewshotConfig(**fcfg), proto,
                        AsvspoofDataset(proto, fixture_train["audio_dir"], cut=cut),
                        mesh=mesh, device=dev)
    tr.model.load_state_dict(sd, strict=True)
    hist = tr.fit()
    check_replicated(tr.model)
    return {"history": [(h["loss"], h["acc"]) for h in hist],
            "state_dict": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}


@rank_fn
def tp_run(dev, name, cfg_name, sd, audio, labels, mp, steps):
    """The tensor-parallel model over a (world/mp, mp) mesh: its eval logits
    on the whole batch, then ``steps`` data-parallel train steps, and the
    whole (gathered) state dict after them."""
    from adfmsl_torch.parallel.tp import gather_params_tp, shard_params_tp

    exp = deterministic(make_experiment(name))
    exp.model.wav2vec2.model_name = cfg_name
    exp.model.wav2vec2.freeze = False
    exp.data.cut = audio.shape[1]
    mesh = make_mesh(MeshConfig(model_parallel=mp))
    model = build_model(exp.model, device=dev)
    model.load_state_dict(sd, strict=True)
    shard_params_tp(model, mesh)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(audio))["logits"]
    st = TrainState(model, Optimizer.for_model(exp, model, 10), seed=0)
    step = make_train_step(exp, mesh)
    losses = []
    for i in range(steps):
        a, y = shard_batch(mesh, [torch.from_numpy(audio), torch.from_numpy(labels).long()])
        met = step(st, a, y, torch.ones(len(a), dtype=torch.bool),
                   st.generators(0, i, mesh.data_rank))
        losses.append(float(met["loss"]))
    return {"logits": logits, "loss": losses, "state_dict": gather_params_tp(model, mesh),
            "local_heads": model.wav2vec2.layers_0.attention.heads}


@rank_fn
def raise_on_rank(dev, rank_to_fail):
    """Rank ``rank_to_fail`` raises; the others wait in a collective."""
    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


@rank_fn
def hang(dev):
    """Every rank but 0 waits in a collective that rank 0 never joins."""
    if dist.get_rank() != 0:
        dist.all_reduce(torch.zeros(1))
    else:
        import time
        time.sleep(600)


@rank_fn
def one_rank_equals_plain(dev, name):
    """At a world of one, the data-parallel step and the plain step from the
    same weights, in this process: are loss, parameters and statistics
    bitwise equal?"""
    import copy

    exp = deterministic(make_experiment(name))
    mesh = make_mesh(MeshConfig())
    x = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal((4, exp.data.cut)))
                         .astype(np.float32))
    y, m = torch.tensor([0, 0, 1, 0]), torch.ones(4, dtype=torch.bool)
    model = build_model(exp.model, device=dev, seed=3)
    twin, warm = copy.deepcopy(model), copy.deepcopy(model)
    out = []
    # the first step of a process is run once more: oneDNN's first calls on a
    # loaded host do not always round as its later ones do
    for mdl, step_mesh in ((warm, None), (model, None), (twin, mesh)):
        st = TrainState(mdl, Optimizer.for_model(exp, mdl, 10), seed=0)
        met = make_train_step(exp, step_mesh)(st, x, y, m, st.generators(0, 0))
        out.append((float(met["loss"]), mdl.state_dict()))
    out = out[1:]
    return {"loss": [o[0] for o in out], "loss_equal": out[0][0] == out[1][0],
            "state_equal": all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])}


@rank_fn
def mesh_layout(dev, cfg):
    """This rank's place in the mesh and the members of its groups, found
    through an ``all_reduce`` of one-hot rank vectors."""
    mesh = make_mesh(cfg)
    out = {"dp": mesh.dp, "mp": mesh.mp, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    for key, group in (("data_group", mesh.data_group), ("model_group", mesh.model_group)):
        v = torch.zeros(mesh.world)
        v[mesh.rank] = 1.0
        dist.all_reduce(v, group=group)
        out[key] = [int(i) for i in np.flatnonzero(v.numpy())]
    return out