"""The port's evaluate CLI end to end vs adfmsl on the synthetic fixture.

A maze5 checkpoint carried over from an adfmsl init (f32 config, so the
comparison is tight) goes through ``adfmsl_torch.cli.evaluate.main`` on the
CPU; the score file must list the protocol's utterances in order with scores
within rtol 1e-4 of adfmsl's model on the same audio (adfmsl's DataLoader),
and the EER must equal adfmsl's within one step of the smaller class (1/n).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.data import AsvspoofDataset as JaxDataset
from adfmsl.data import DataLoader as JaxLoader
from adfmsl.data import parse_protocol as jax_parse_protocol
from adfmsl.evaluation import compute_eer as jax_compute_eer
from adfmsl.models import build_model as jax_build_model
from adfmsl_torch.cli import evaluate
from adfmsl_torch.config import make_experiment
from adfmsl_torch.evaluation import compute_eer
from adfmsl_torch.models import build_model, save_checkpoint, state_dict_from_flax

CUT, BATCH = 6000, 6


@pytest.fixture(scope="module")
def jax_run(fixture_dir):
    """adfmsl maze5 (f32) with non-trivial BN stats, scored on the eval split."""
    rng = np.random.default_rng(77)
    exp = jax_experiment("maze5")
    exp.data.cut = CUT
    exp.model.dtype = "float32"
    model = jax_build_model(exp.model)
    x0 = jnp.zeros((BATCH, CUT), jnp.float32)
    v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(1), x0)
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    stats = jax.tree.map(
        lambda a: np.abs(rng.standard_normal(a.shape).astype(np.float32) * 0.3) + 0.1,
        v["batch_stats"])
    params["fc2"]["kernel"] = params["fc2"]["kernel"] * 30.0      # O(1) logits
    apply = jax.jit(lambda x: model.apply({"params": params, "batch_stats": stats},
                                          x, train=False)["scores"])
    ev = fixture_dir["eval"]
    proto = jax_parse_protocol(ev["protocol"])
    loader = JaxLoader(JaxDataset(proto, ev["audio_dir"], cut=CUT,
                                  use_native_io=False), BATCH, prefetch=0)
    ids, scores = [], []
    for batch in loader:
        s = np.asarray(apply(jnp.asarray(batch.audio)))
        for u, sc, m in zip(batch.utt_ids, s, batch.mask):
            if m:
                ids.append(u)
                scores.append(float(sc))
    return {"params": params, "stats": stats, "ids": ids,
            "scores": np.asarray(scores), "labels": proto.labels}


def test_cli_score_file_and_eer_match_adfmsl(jax_run, fixture_dir, tmp_path, capsys):
    exp = make_experiment("maze5")
    exp.data.cut = CUT
    exp.model.dtype = "float32"
    model = build_model(exp.model, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax_run["params"], jax_run["stats"],
                                               "maze5"), strict=True)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), exp, model)
    out = tmp_path / "scores.txt"
    ev = fixture_dir["eval"]
    rc = evaluate.main(["--model_type", "maze5", "--model_path", str(ckpt),
                        "--protocol", ev["protocol"], "--data_dir", ev["audio_dir"],
                        "--output", str(out), "--batch_size", str(BATCH),
                        "--cut", str(CUT), "--device", "cpu", "--smoke_test"])
    assert rc == 0
    assert "'eer'" in capsys.readouterr().out
    lines = [ln.split() for ln in out.read_text().splitlines()]
    ids = [u for u, _ in lines]
    scores = np.asarray([float(s) for _, s in lines])
    assert ids == jax_run["ids"] == ev["utt_ids"]               # protocol order
    np.testing.assert_allclose(scores, jax_run["scores"], rtol=1e-4, atol=0)
    labels = np.asarray([jax_run["labels"][u] for u in ids])
    eer, _ = compute_eer(scores, labels)
    ref, _ = jax_compute_eer(jax_run["scores"], labels)
    n_min = min(int(labels.sum()), int((1 - labels).sum()))
    assert abs(eer - ref) <= 1.0 / n_min


def test_cli_random_init_folded_trunk_on_cpu(fixture_dir, tmp_path, capsys):
    """The default bf16 config runs the folded trunk (K1's plain version on the
    CPU) through the CLI and writes one finite score per utterance."""
    ev = fixture_dir["eval"]
    out = tmp_path / "s.txt"
    rc = evaluate.main(["--model_type", "maze5_fmsl", "--protocol", ev["protocol"],
                        "--data_dir", ev["audio_dir"], "--output", str(out),
                        "--batch_size", "8", "--cut", str(CUT), "--device", "cpu",
                        "--seed", "3"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ev["utt_ids"]
    assert np.isfinite([float(ln.split()[1]) for ln in lines]).all()
    assert "'eer'" in capsys.readouterr().out
