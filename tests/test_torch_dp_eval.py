"""Data-parallel evaluation of the port against adfmsl's mesh evaluation
(``adfmsl/evaluation/runner.py`` :77-89), the evaluate CLI's
``--data_parallel``, and the runner's OOM half-batch retry (:90-115).

- ``evaluate_to_file(mesh=...)`` on 2 spawned gloo ranks (CPU, 300 s limit)
  over the fixture's eval split at batch 5 (not a multiple of 2: each batch
  is padded with a masked row), maze5 at f32 from adfmsl's initial weights
  (``state_dict_from_flax``), fed a loader of each rank's rows: ids equal
  adfmsl's mesh run's and the protocol's, scores within
  ``tests/test_parallel.py``'s rtol 1e-5 (atol 1e-6), the same EER; rank 0
  alone writes the score file. The runner and the Trainer refuse, under a
  mesh, a loader that is not the rank's (it would decode every row).
- ``cli.evaluate --data_parallel 2 --dist_backend gloo --dist_timeout 300
  --device cpu`` (maze5,
  bf16, random init): the one-process file's ids in order, scores within the
  bf16 tolerance of ``tests/test_pallas.py`` (3e-2 * max(1, |s|)); each rank
  prints its summary.
- The OOM retry, with ``torch.OutOfMemoryError`` raised by the model for
  batches above a size: halves (and halves of halves) give the unsplit
  scores exactly; a batch of one re-raises; the 101st error trips the
  circuit breaker.
"""
import json

import numpy as np
import pytest
import torch

from adfmsl_torch.data import Batch
from adfmsl_torch.evaluation import produce_scores
from adfmsl_torch.evaluation.runner import MAX_OOM_ERRORS
from adfmsl_torch.parallel import launch
import torch_rank_workers as W

CUT = 4000


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_mesh_eval_matches_adfmsl_mesh_eval(fixture_dir, tmp_path):
    import jax
    import jax.numpy as jnp

    from adfmsl.config import MeshConfig as JaxMeshConfig
    from adfmsl.config import make_experiment as jax_experiment
    from adfmsl.data import parse_protocol as jax_parse
    from adfmsl.evaluation import evaluate_to_file as jax_evaluate
    from adfmsl.models import build_model as jax_build_model
    from adfmsl.parallel import make_mesh, replicate
    from adfmsl.train import TrainState, make_dataset_and_loader, make_eval_step
    from adfmsl.train import make_optimizer

    from adfmsl_torch.models import state_dict_from_flax

    ev = fixture_dir["eval"]
    exp = jax_experiment("maze5")
    exp.data.cut = CUT
    exp.model.dtype = "float32"
    model = jax_build_model(exp.model)
    v = model.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((2, CUT)), train=False)
    tx, _ = make_optimizer(exp, 10)
    state = TrainState.create(model.apply, v["params"], v.get("batch_stats"), tx)
    mesh = make_mesh(JaxMeshConfig(), devices=jax.devices()[:2])
    state = state.replace(params=replicate(mesh, state.params),
                          batch_stats=replicate(mesh, state.batch_stats),
                          opt_state=replicate(mesh, state.opt_state))
    proto = jax_parse(ev["protocol"])
    loader = make_dataset_and_loader(exp, proto, ev["audio_dir"], shuffle=False,
                                     batch_size=5, drop_last=False)
    ref = jax_evaluate(state, loader, str(tmp_path / "ref.txt"), labels=proto.labels,
                       eval_step=jax.jit(make_eval_step(exp)), mesh=mesh)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, v["params"]),
                              jax.tree.map(np.asarray, v["batch_stats"]), "maze5")
    path = str(tmp_path / "port.txt")
    out = launch(W.mesh_scores, 2, ("maze5", "float32", sd, ev["protocol"],
                                    ev["audio_dir"], CUT, 5, path),
                 backend="gloo", device="cpu", timeout=W.LIMIT)
    for o in out:
        assert o["utt_ids"] == ref.utt_ids == proto.utt_ids
        np.testing.assert_allclose(o["scores"], ref.scores, rtol=1e-5, atol=1e-6)
        assert o["metrics"]["eer"] == pytest.approx(ref.metrics["eer"], abs=1e-9)
    with open(path) as fh:
        assert [ln.split()[0] for ln in fh] == proto.utt_ids


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_mesh_paths_refuse_a_loader_not_of_the_rank(fixture_dir, rank, world):
    """Data rank 0 of 2 takes only a loader of its own row blocks: a global
    loader (world 1) and another rank's loader both raise, in the runner and
    in the Trainer, before any collective."""
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.data import AsvspoofDataset, DataLoader, parse_protocol
    from adfmsl_torch.parallel import Mesh
    from adfmsl_torch.train import Trainer

    ev = fixture_dir["eval"]
    loader = DataLoader(AsvspoofDataset(parse_protocol(ev["protocol"]), ev["audio_dir"],
                                        cut=CUT), 4, rank=rank, world=world)
    mesh = Mesh(dp=2, mp=1, rank=0, data_group=None, model_group=None)
    with pytest.raises(ValueError, match="rank=0, world=2"):
        produce_scores(_OOMAbove(8), loader, mesh=mesh)
    exp = make_experiment("lcnn1d_lfcc")
    exp.data.cut = CUT
    with pytest.raises(ValueError, match="rank=0, world=2"):
        Trainer(exp, loader, mesh=mesh, device="cpu")


def test_evaluate_cli_data_parallel_writes_the_one_process_file(fixture_dir, tmp_path,
                                                                capfd):
    from adfmsl_torch.cli import evaluate

    ev = fixture_dir["eval"]
    files = {}
    for label, extra in (("one", []), ("two", ["--data_parallel", "2", "--dist_backend",
                                               "gloo", "--dist_timeout", str(W.LIMIT)])):
        files[label] = str(tmp_path / f"{label}.txt")
        rc = evaluate.main(["--model_type", "maze5", "--protocol", ev["protocol"],
                            "--data_dir", ev["audio_dir"], "--output", files[label],
                            "--cut", str(CUT), "--batch_size", "5", "--device", "cpu",
                            *extra])
        assert rc == 0
    rows = {}
    for label, path in files.items():
        with open(path) as fh:
            rows[label] = [ln.split() for ln in fh.read().splitlines()]
    assert [r[0] for r in rows["two"]] == [r[0] for r in rows["one"]] == ev["utt_ids"]
    got = np.asarray([float(r[1]) for r in rows["two"]])
    ref = np.asarray([float(r[1]) for r in rows["one"]])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * max(1.0, np.abs(ref).max()))
    summaries = [json.loads(ln.split(" ", 1)[1]) for ln in capfd.readouterr().out.splitlines()
                 if ln.startswith("rank_summary ")]
    assert sorted(s["rank"] for s in summaries) == [0, 1]


class _OOMAbove(torch.nn.Module):
    """Row-wise scores; raises ``torch.OutOfMemoryError`` for batches of more
    than ``limit`` rows."""

    def __init__(self, limit: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, CUT))
        self.limit, self.calls = limit, []

    def forward(self, audio):
        self.calls.append(len(audio))
        if len(audio) > self.limit:
            raise torch.OutOfMemoryError("out of memory (injected)")
        return {"scores": (audio * self.w).sum(-1)}


def _batches(n_batches, size, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        ids = [f"u{i}_{j}" for j in range(size)]
        out.append(Batch(rng.standard_normal((size, CUT)).astype(np.float32),
                         np.zeros(size, np.int32), np.ones(size, bool), ids))
    return out


def test_oom_retry_in_halves_keeps_the_scores():
    batches = _batches(3, 8)
    ref = produce_scores(_OOMAbove(8), batches)
    for limit, calls in ((4, [8, 4, 4]), (2, [8, 4, 2, 2, 4, 2, 2])):
        model = _OOMAbove(limit)
        got = produce_scores(model, batches)
        assert got.utt_ids == ref.utt_ids
        np.testing.assert_array_equal(got.scores, ref.scores)
        assert model.calls == calls * 3


def test_oom_on_a_batch_of_one_reraises_and_the_breaker_trips():
    with pytest.raises(torch.OutOfMemoryError):
        produce_scores(_OOMAbove(0), _batches(1, 2))
    model = _OOMAbove(1)
    with pytest.raises(torch.OutOfMemoryError):
        produce_scores(model, _batches(MAX_OOM_ERRORS + 1, 2))
    assert model.calls.count(2) == MAX_OOM_ERRORS + 1
    model = _OOMAbove(1)
    assert len(produce_scores(model, _batches(MAX_OOM_ERRORS, 2)).scores) == \
        2 * MAX_OOM_ERRORS
