"""The port's bootstrap, analysis layer and analysis CLIs against adfmsl's,
and the port's batch CLI.

- ``bootstrap_metric`` / ``paired_bootstrap_test`` equal adfmsl's exactly
  (the same numpy draws on the same seed): three seeds, a set with one
  bonafide row (the forced class), tied, mostly equal and f32 scores (the
  port sorts once a call, adfmsl once a resample), the single-class
  ``ValueError``.
- The same score directory and protocol go through both packages'
  ``cli.analyze --figures --regression`` (and ``--embeddings``, ``--curves``)
  and ``cli.compare``: the report files are byte-equal, the printed lines
  (with the output directory's name replaced) and return codes equal, and the
  same figure files exist; ``plot_embedding_geometry``'s projections equal
  adfmsl's within 1e-5 * max(1, |ref|).
- ``detect_architecture``, ``count_params`` and ``model_summary`` of the
  port's modules equal adfmsl's over its parameter trees.
- ``cli.batch --device cpu`` trains two small models for one epoch; each
  score file equals a separate ``cli.train`` + ``cli.evaluate`` run's.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl_torch.evaluation import bootstrap_metric, paired_bootstrap_test

CUT = 4000


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels_scores(seed, n=300, n_bona=None):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(int)
    if n_bona is not None:
        y = np.zeros(n, int)
        y[rng.choice(n, n_bona, replace=False)] = 1
    a = y * 1.5 + rng.normal(0, 1.0, n)
    b = y * 0.7 + rng.normal(0, 1.0, n)
    return y, a, b


@pytest.mark.parametrize("seed,n_bona", [(0, None), (1, None), (7, None), (3, 1)])
def test_bootstrap_equals_adfmsl(seed, n_bona):
    from adfmsl.evaluation import bootstrap_metric as jb
    from adfmsl.evaluation import paired_bootstrap_test as jp

    y, a, b = _labels_scores(seed, n_bona=n_bona)
    got, ref = bootstrap_metric(a, y, n_resamples=60, seed=seed), jb(a, y, n_resamples=60,
                                                                     seed=seed)
    assert (got.point, got.ci_low, got.ci_high) == (ref.point, ref.ci_low, ref.ci_high)
    np.testing.assert_array_equal(got.samples, ref.samples)
    assert paired_bootstrap_test(a, b, y, n_resamples=60, seed=seed) == jp(
        a, b, y, n_resamples=60, seed=seed)
    if n_bona == 1:
        # the forced draw: most resamples miss the one bonafide row
        assert np.isfinite(got.samples).all()


@pytest.mark.parametrize("ties", ["rounded", "mostly_zero", "float32"])
def test_bootstrap_with_ties_equals_adfmsl(ties):
    """The port sorts the scores once and counts each resample's distinct
    scores; adfmsl sorts every resample. Tied, mostly equal (with -0.0) and
    f32 scores give the same EERs, exactly."""
    from adfmsl.evaluation import bootstrap_metric as jb
    from adfmsl.evaluation import paired_bootstrap_test as jp

    y, a, b = _labels_scores(11)
    if ties == "rounded":
        a, b = np.round(a, 1), np.round(b)
    elif ties == "mostly_zero":
        a[: len(a) * 3 // 4], b = 0.0, -np.abs(np.round(b))
    else:
        a, b = a.astype(np.float32), b.astype(np.float32)
    got, ref = bootstrap_metric(a, y, n_resamples=40, seed=5), jb(a, y, n_resamples=40, seed=5)
    assert (got.point, got.ci_low, got.ci_high) == (ref.point, ref.ci_low, ref.ci_high)
    np.testing.assert_array_equal(got.samples, ref.samples)
    assert paired_bootstrap_test(a, b, y, n_resamples=40, seed=5) == jp(
        a, b, y, n_resamples=40, seed=5)


def test_bootstrap_single_class_raises():
    y = np.ones(20, int)
    with pytest.raises(ValueError, match="both classes"):
        bootstrap_metric(np.arange(20.0), y)
    with pytest.raises(ValueError, match="both classes"):
        paired_bootstrap_test(np.arange(20.0), np.arange(20.0), y)


def test_join_scores_with_labels():
    from adfmsl.evaluation import join_scores_with_labels as ref
    from adfmsl_torch.evaluation import join_scores_with_labels

    scores, labels = {"a": 0.5, "b": -1.0, "c": 2.0}, {"a": 1, "c": 0, "d": 1}
    assert join_scores_with_labels(scores, labels) == ref(scores, labels) == (
        [0.5, 2.0], [1, 0], ["b"])


@pytest.fixture(scope="module")
def analysis_inputs(tmp_path_factory):
    """Two models' score files (a baseline / FMSL pair), their protocol, an
    embedding dump and a metrics log."""
    from adfmsl_torch.utils import MetricsLogger

    root = tmp_path_factory.mktemp("analysis")
    rng = np.random.default_rng(5)
    n = 240
    ids = [f"LA_E_{i:07d}" for i in range(n)]
    y = (np.arange(n) % 3 == 0).astype(int)
    proto = root / "proto.txt"
    proto.write_text("".join(f"LA_{i % 7:04d} {u} - {'-' if y[i] else 'A07'} "
                             f"{'bonafide' if y[i] else 'spoof'}\n" for i, u in enumerate(ids)))
    sdir = root / "scores"
    sdir.mkdir()
    for name, sep in (("maze5", 1.2), ("maze5_fmsl", 2.0)):
        s = y * sep + rng.normal(0, 1, n)
        (sdir / f"{name}_scores.txt").write_text(
            "".join(f"{u} {v}\n" for u, v in zip(ids[:-3], s[:-3])) + "extra_utt 0.5\n")
    feats = (rng.standard_normal((n, 16)) + y[:, None] * 0.8).astype(np.float32)
    protos = rng.standard_normal((3, 16)).astype(np.float32)
    npz = root / "maze5_fmsl_emb.npz"
    np.savez(npz, utt_ids=np.array(ids), features=feats, scores=np.zeros(n),
             prototypes=protos, class_weights=protos[:2])
    log = MetricsLogger(str(root / "logs"), also_tensorboard=False)
    for e, (loss, acc) in enumerate([(1.0, 0.5), (0.5, 0.8)]):
        log.add_scalars({"train/loss": loss, "dev/acc": acc}, e)
    log.close()
    return {"root": root, "proto": str(proto), "scores": str(sdir), "npz": str(npz),
            "logs": str(root / "logs"), "feats": feats, "y": y, "protos": protos}


def _run_cli(main, argv, capsys, out_dir):
    rc = main(argv)
    text = capsys.readouterr().out
    return rc, text.replace(out_dir, "<out>") if out_dir else text


def _files(d):
    return sorted(os.listdir(d))


def test_analyze_cli_matches_adfmsl(analysis_inputs, tmp_path, capsys):
    from adfmsl.cli.analyze import main as jax_main
    from adfmsl_torch.cli.analyze import main as port_main

    a = analysis_inputs
    outs = {}
    for tag, main in (("jax", jax_main), ("port", port_main)):
        out = str(tmp_path / tag)
        argv = ["--scores_dir", a["scores"], "--protocol", a["proto"], "--output_dir", out,
                "--figures", "--regression", "0.001", "--embeddings", a["npz"],
                "--curves", a["logs"]]
        outs[tag] = (out, *_run_cli(main, argv, capsys, out))
    (jd, jrc, jtext), (pd, prc, ptext) = outs["jax"], outs["port"]
    assert jrc == prc == 2                       # random scores miss the thesis EERs
    assert ptext == jtext and "regression FAIL: maze5 EER" in ptext
    assert _files(pd) == _files(jd)
    for f in ("results.csv", "results.tex", "report.md", "processed_performance_data.json"):
        with open(os.path.join(jd, f), "rb") as x, open(os.path.join(pd, f), "rb") as z:
            assert z.read() == x.read(), f
    for f in ("roc.png", "det.png", "model_comparison.png", "trend_visualizations.png",
              "comprehensive_histogram.png", "maze5_score_dist.png",
              "embedding_geometry_maze5_fmsl_emb.png", "training_curves.png"):
        assert os.path.getsize(os.path.join(pd, f)) > 1000, f

    empty = tmp_path / "empty"
    empty.mkdir()
    for main in (jax_main, port_main):
        assert _run_cli(main, ["--scores_dir", str(empty), "--protocol", a["proto"],
                               "--output_dir", str(tmp_path / "e")], capsys, "") == (
            1, f"no score files found under {empty}\n")


def test_compare_cli_matches_adfmsl(analysis_inputs, tmp_path, capsys):
    from adfmsl.cli.compare import main as jax_main
    from adfmsl_torch.cli.compare import main as port_main

    a = analysis_inputs
    texts = {}
    for tag, main in (("jax", jax_main), ("port", port_main)):
        out = str(tmp_path / tag)
        argv = ["--scores_a", os.path.join(a["scores"], "maze5_scores.txt"),
                "--scores_b", os.path.join(a["scores"], "maze5_fmsl_scores.txt"),
                "--protocol", a["proto"], "--output_dir", out, "--n_resamples", "50"]
        texts[tag] = _run_cli(main, argv, capsys, out)
    assert texts["port"] == texts["jax"] and texts["port"][0] == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "comparison.md", "det.png", "maze5_dist.png", "maze5_fmsl_dist.png", "roc.png"]
    assert (tmp_path / "port" / "comparison.md").read_bytes() == (
        tmp_path / "jax" / "comparison.md").read_bytes()


class _Recorder:
    """Stands in for matplotlib's pyplot, figure and axes: records each
    ``scatter`` call's points."""

    def __init__(self, calls):
        self.calls = calls

    def subplots(self, *a, **k):
        return self, (self, self)

    def scatter(self, x, y, **k):
        self.calls.append((k.get("label"), np.column_stack([x, y])))

    def __getattr__(self, name):
        return lambda *a, **k: None


def test_embedding_geometry_projection_matches_adfmsl(analysis_inputs, monkeypatch):
    import adfmsl.analysis.figures as jf
    import adfmsl_torch.analysis.figures as pf

    a = analysis_inputs
    calls = {}
    for tag, mod in (("jax", jf), ("port", pf)):
        calls[tag] = []
        monkeypatch.setattr(mod, "_plt", lambda c=calls[tag]: _Recorder(c))
        mod.plot_embedding_geometry(a["feats"], a["y"], "unused.png",
                                    prototypes=a["protos"], class_weights=a["protos"][:2])
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]] == [
        "bonafide", "spoof", "spoof prototypes", "class weights"]
    for (_, got), (_, ref) in zip(calls["port"], calls["jax"]):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def _jax_params(name):
    """adfmsl's parameter tree of ``name`` at cut 4000, as zeros of the
    shapes ``eval_shape`` gives (no compile)."""
    from adfmsl.config import make_experiment
    from adfmsl.models import build_model

    exp = make_experiment(name)
    exp.data.cut = CUT
    if name.startswith("maze6"):
        exp.model.wav2vec2.model_name = "tiny"
    m = build_model(exp.model)
    shapes = jax.eval_shape(lambda k, x: m.init({"params": k}, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, CUT)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])


def _port_model(name):
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model

    exp = make_experiment(name)
    exp.data.cut = CUT
    if name.startswith("maze6"):
        exp.model.wav2vec2.model_name = "tiny"
    return build_model(exp.model, device="cpu")


@pytest.mark.parametrize("name,n_params", [("maze5", 1_007_362), ("maze5_fmsl", 2_064_131),
                                           ("main", 6_996_482), ("maze6_fmsl", None)])
def test_summaries_match_adfmsl(name, n_params):
    from adfmsl.analysis import count_params as jcount
    from adfmsl.analysis import detect_architecture as jdetect
    from adfmsl.analysis import model_summary as jsummary
    from adfmsl_torch.analysis import count_params, detect_architecture, model_summary

    ref, model = _jax_params(name), _port_model(name)
    assert detect_architecture(model) == detect_architecture(model.state_dict()) == jdetect(ref)
    assert count_params(model) == jcount(ref)
    if n_params is not None:
        assert count_params(model) == n_params
    for depth in (1, 2, 3):
        assert model_summary(model, depth) == jsummary(ref, depth)


def test_detect_architecture_w2v2_and_check_compatibility():
    from adfmsl_torch.analysis import check_compatibility, detect_architecture

    model = _port_model("maze6_fmsl")
    info = detect_architecture(model)
    assert info["has_wav2vec2"] and info["has_fmsl"] and not info["has_sinc"]
    assert (info["wav2vec2_dim"], info["wav2vec2_layers"]) == (64, 2)
    assert (info["n_prototypes"], info["fmsl_dim"]) == (8, 512)
    sd = model.state_dict()
    assert not any(check_compatibility(model, sd).values())
    broken = dict(sd)
    broken.pop("fmsl.weight")
    broken["fmsl.prototypes"] = torch.zeros(2, 512)
    broken["extra.weight"] = torch.zeros(1)
    assert check_compatibility(model, broken) == {
        "missing": ["fmsl.weight"], "unexpected": ["extra.weight"],
        "shape_mismatch": ["fmsl.prototypes"]}


def test_batch_cli_equals_train_and_evaluate(tmp_path, capsys):
    """Two models for one epoch (2 steps of 4) at cut 4000: the batch CLI's
    outputs, and each score file against ``cli.train`` + ``cli.evaluate``."""
    import yaml

    from adfmsl_torch.cli import batch, evaluate, train
    from adfmsl_torch.config import make_experiment, save_yaml
    from adfmsl_torch.config.standardized import apply_overrides
    from adfmsl_torch.data import SyntheticSpec, generate_fixture

    fx = generate_fixture(str(tmp_path / "fx"), SyntheticSpec(n_train=8, n_dev=2, n_eval=6))
    tr, ev = fx["train"], fx["eval"]
    overrides = {"train.num_epochs": 1, "train.batch_size": 4, "train.eval_batch_size": 4,
                 "data.cut": CUT, "data.prefetch": 0, "model.spec_augment.enabled": False}
    plan = {"models": ["maze5", "lcnn1d_lfcc"], "overrides": overrides,
            "per_model": {"lcnn1d_lfcc": {"train.optimizer.lr": 2e-4}}}
    cfg = tmp_path / "plan.yaml"
    cfg.write_text(yaml.safe_dump(plan))
    out = tmp_path / "batch_out"
    rc = batch.main(["--config", str(cfg), "--train_protocol", tr["protocol"],
                     "--train_dir", tr["audio_dir"], "--eval_protocol", ev["protocol"],
                     "--eval_dir", ev["audio_dir"], "--output_dir", str(out),
                     "--device", "cpu"])
    assert rc == 0
    assert "maze5" in capsys.readouterr().out
    for f in ("results.csv", "report.md", "processed_performance_data.json"):
        assert (out / f).exists(), f
    assert sorted(os.listdir(out / "scores")) == ["lcnn1d_lfcc_scores.txt", "maze5_scores.txt"]
    assert "lcnn1d_lfcc" in (out / "results.csv").read_text()

    for name in plan["models"]:
        exp = make_experiment(name)
        apply_overrides(exp, overrides)
        apply_overrides(exp, plan["per_model"].get(name))
        ycfg = tmp_path / f"{name}.yaml"
        save_yaml(exp, str(ycfg))
        ck = tmp_path / f"ck_{name}"
        assert train.main(["--config", str(ycfg), "--train_protocol", tr["protocol"],
                           "--train_dir", tr["audio_dir"],
                           "--dev_protocol", str(tmp_path / "none.txt"),
                           "--checkpoint_dir", str(ck), "--device", "cpu"]) == 0
        scores = tmp_path / f"{name}_scores.txt"
        assert evaluate.main(["--model_type", name, "--model_path", str(ck),
                              "--protocol", ev["protocol"], "--data_dir", ev["audio_dir"],
                              "--batch_size", "4", "--no_fused_trunk", "--device", "cpu",
                              "--output", str(scores)]) == 0
        assert scores.read_bytes() == (out / "scores" / f"{name}_scores.txt").read_bytes()
