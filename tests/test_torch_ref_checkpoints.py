"""Reference torch checkpoints (``.pth``) into the port, with no JAX forward:
the independent torch models of tests/test_port.py with random weights and
BatchNorm statistics are the reference.

- All 16 maze models (maze4_fmsl assembled from test_port's ``TSinc``,
  ``TAdaptBlock``, ``TSE`` and ``TFMSL`` with ``TMaze7``'s FMSL head, to the
  keys adfmsl's ``models/port.py:332-353`` maps): the port's
  ``port_maze_state_dict`` gives the tree and the report of adfmsl's, array
  for array, and the converted port model's f32 logits (or log-softmax) match
  the torch model's at tests/test_port.py's tolerance for it.
- ``tests/torch_ref_nets.py`` (the card's copy of the sinc and RawNet
  references, jax-free) computes what test_port's do on the same weights.
- ``load_torch_state_dict``'s rich-dict unwrap; a dict with one key dropped and
  one added reports the same ``missing`` / ``unconsumed`` in both packages and
  still converts; ``merge``'s shape check.
- ``python -m adfmsl_torch.cli.convert_maze`` -> ``cli.evaluate --model_path
  --device cpu`` on a small fixture: the scores within atol 5e-4, rtol 1e-3
  of the torch model (tests/test_port.py:919-961); the emitted
  ``experiment.yaml`` loads in adfmsl to adfmsl's
  ``reference_parity_experiment``; ``cli.train --config OUT/experiment.yaml
  --checkpoint_dir OUT --restore --device cpu`` scores the converted weights
  under ``--eval`` and fine-tunes from them.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

import test_port as tp
import torch_ref_nets
from adfmsl.models.port import load_torch_state_dict as jax_load
from adfmsl.models.port import port_maze_state_dict as jax_port
from adfmsl.models.w2v2 import W2V2Arch as JaxArch
from adfmsl_torch.models import (SPECS, MazeModel, load_torch_state_dict, merge,
                                 port_maze_state_dict, reference_parity_experiment,
                                 state_dict_from_flax)
from adfmsl_torch.models.w2v2 import W2V2Arch

CUT = 4000
SINC = ("maze4", "maze4_fmsl", "maze5", "maze5_fmsl", "main", "main_fmsl")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class TMaze4FMSL(tnn.Module):
    """maze4_fmsl (maze4_fmsl_standardized.py:216-347): the sinc front end,
    the adaptive blocks (:112-162) with their SE gates, the pooled trunk into
    the FMSL system, AM-softmax logits (test_port's ``TMaze7`` head)."""

    def __init__(self, s):
        super().__init__()
        self.s = s
        self.sinc_conv = tp.TSinc()
        self.first_bn = tnn.BatchNorm1d(128)
        self.block0 = tp.TAdaptBlock(128, 128, first=True)
        self.se0 = tp.TSE(128)
        plan = [(128, 128), (128, 128), (128, 128), (128, 256)]
        self.res_blocks = tnn.ModuleList(tp.TAdaptBlock(a, b, stride=2) for a, b in plan)
        self.se_blocks = tnn.ModuleList(tp.TSE(b) for _, b in plan)
        self.fmsl_system = tp.TFMSL(256)

    def forward(self, x):
        h = tF.selu(self.first_bn(self.sinc_conv(x.unsqueeze(1))))
        h = self.se0(self.block0(h))
        for blk, se in zip(self.res_blocks, self.se_blocks):
            h = se(blk(h))
        emb = self.fmsl_system(h.mean(dim=2))
        return self.s * (emb @ tF.normalize(self.fmsl_system.weight, p=2, dim=-1).T)


def _drift_s(name):
    return reference_parity_experiment(name).model.fmsl.s


# name -> (the torch reference, cut, the transformer's layers when cut to the
# reference's, tests/test_port.py's comparison: the log-softmax within an
# absolute atol, or the logits within atol * max(1, |logits|))
REFERENCES = {
    "main": (lambda: tp.TRawNet(gru_layers=2), 8000, None, ("log_softmax", 1e-3)),
    "main_fmsl": (lambda: tp.TRawNet(gru_layers=2, fmsl=True), 8000, None, ("logits", 1e-3)),
    "maze2": (tp.TMaze2, CUT, 2, ("log_softmax", 1e-3)),
    "maze2_fmsl": (tp.TMaze2FMSL, CUT, None, ("logits", 1e-3)),
    "maze3": (tp.TMaze3, CUT, None, ("logits", 1e-3)),
    "maze3_fmsl": (tp.TMaze3FMSL, CUT, 2, ("logits", 1e-3)),
    "maze4": (tp.TMaze5, CUT, None, ("log_softmax", 2e-4)),
    "maze4_fmsl": (lambda: TMaze4FMSL(_drift_s("maze4_fmsl")), CUT, None, ("logits", 1e-3)),
    "maze5": (tp.TMaze5, CUT, None, ("log_softmax", 2e-4)),
    "maze5_fmsl": (lambda: tp.TMaze5(fmsl=True), CUT, None, ("log_softmax", 2e-4)),
    "maze6": (tp.TMaze6, CUT, 2, ("logits", 1e-3)),
    "maze6_fmsl": (tp.TMaze6FMSL, CUT, None, ("logits", 1e-3)),
    "maze7": (lambda: tp.TMaze7(), CUT, None, ("log_softmax", 1e-3)),
    "maze7_fmsl": (lambda: tp.TMaze7(fmsl=True, fmsl_s=_drift_s("maze7_fmsl")), CUT, None,
                   ("logits", 1e-3)),
    "maze8": (lambda: tp.TMaze7(conv_fmsl=True), CUT, None, ("log_softmax", 1e-3)),
    "maze8_fmsl": (lambda: tp.TMaze7(fmsl=True, fmsl_s=_drift_s("maze8_fmsl")), CUT, None,
                   ("logits", 1e-3)),
}


def _reference(name, seed):
    torch.manual_seed(seed)
    make = REFERENCES[name][0]
    model = make().eval()
    with torch.no_grad():
        tp._randomize_bn_stats(model, np.random.default_rng(seed))
    return model


def _numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _port_model(name, params, stats, report, cut, layers):
    exp = reference_parity_experiment(name)
    exp.data.cut = cut
    exp.model.wav2vec2.model_name = "tiny"
    if report.get("gru_layers"):
        exp.model.architecture.nb_gru_layer = report["gru_layers"]
    spec = SPECS[name]
    if layers is not None:
        d, heads, _, ff = spec.transformer
        spec = dataclasses.replace(spec, transformer=(d, heads, layers, ff))
    model = MazeModel(spec, exp.model, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(merge(model.state_dict(),
                                state_dict_from_flax(params, stats, name)), strict=True)
    return model


@pytest.mark.parametrize("name", sorted(REFERENCES))
def test_reference_checkpoint_ports_like_adfmsl_and_scores_like_torch(name):
    _, cut, layers, (form, atol) = REFERENCES[name]
    seed = sorted(REFERENCES).index(name)
    tmodel = _reference(name, seed)
    sd = _numpy_sd(tmodel)
    w2v2 = name not in SINC
    ours = port_maze_state_dict(sd, name, w2v2_arch=W2V2Arch.tiny() if w2v2 else None)
    theirs = jax_port(sd, name, w2v2_arch=JaxArch.tiny() if w2v2 else None)
    _assert_trees_equal(ours[0], theirs[0])
    _assert_trees_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]
    assert ours[2]["missing"] == [] and ours[2]["unconsumed"] == []

    model = _port_model(name, *ours, cut, layers)
    x = np.random.default_rng(seed).standard_normal((2, cut)).astype(np.float32)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x)).numpy()
        logits = model(torch.from_numpy(x))["logits"]
    if form == "log_softmax":
        np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(), ref,
                                   atol=atol, rtol=1e-3)
    else:
        np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-3,
                                   atol=atol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", ["maze5_fmsl", "maze4_fmsl", "main_fmsl"])
def test_card_references_compute_what_test_port_does(name):
    """tests/torch_ref_nets.py against tests/test_port.py on the same state
    dict (the keys must be the same), in f32 on the CPU."""
    ref = _reference(name, 3)
    if name == "maze5_fmsl":
        copy = torch_ref_nets.TMaze5(fmsl=True)
    elif name == "maze4_fmsl":
        copy = torch_ref_nets.TMaze4FMSL(s=_drift_s(name))
    else:
        copy = torch_ref_nets.TRawNet(gru_layers=2, fmsl=True)
    copy.load_state_dict(ref.state_dict(), strict=True)
    copy.eval()
    cut = REFERENCES[name][1]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, cut)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(copy(x).numpy(), ref(x).numpy(), rtol=1e-6, atol=1e-6)
    # randomize draws every weight and statistic from the generator, the same
    # for the same seed
    a = torch_ref_nets.randomize(torch_ref_nets.TMaze5(), torch.Generator().manual_seed(0))
    b = torch_ref_nets.randomize(torch_ref_nets.TMaze5(), torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.first_bn.running_mean, torch.zeros(128))


def test_rich_dict_unwrap_matches_adfmsl(tmp_path):
    """The reference's resume checkpoints wrap the state dict (maze3.py:
    850-880) beside objects that are not tensors; 'state_dict' too."""
    tmodel = _reference("maze5", 0)
    for i, wrap in enumerate(({"epoch": 3, "model_state_dict": tmodel.state_dict(),
                               "loss": 0.5, "args": {"lr": 1e-4}},
                              {"state_dict": tmodel.state_dict(), "note": "x"})):
        p = str(tmp_path / f"rich{i}.pth")
        torch.save(wrap, p)
        ours, theirs = load_torch_state_dict(p), jax_load(p)
        assert set(ours) == set(theirs) == set(tmodel.state_dict())
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours["fc1.weight"].shape == (1024, 256)


def test_dropped_and_added_keys_report_like_adfmsl():
    sd = _numpy_sd(_reference("maze5", 1))
    dropped = sd.pop("res_blocks.1.bn1.running_var")
    sd.pop("se0.fc.2.weight")
    sd.pop("res_blocks.2.bn2.weight")      # a BN left with its statistics alone
    sd.pop("res_blocks.2.bn2.bias")
    sd["extra_head.weight"] = np.ones((2, 2), np.float32)
    ours, theirs = port_maze_state_dict(sd, "maze5"), jax_port(sd, "maze5")
    assert ours[2] == theirs[2] == {
        "missing": ["se0.fc.2.weight", "res_blocks.1.bn1.running_var",
                    "res_blocks.2.bn2.weight", "res_blocks.2.bn2.bias"],
        "unconsumed": ["extra_head.weight"]}
    _assert_trees_equal(ours[0], theirs[0])
    _assert_trees_equal(ours[1], theirs[1])
    # the rest converts; the missing leaves keep the model's init
    model = _port_model("maze5", *ours, CUT, None)
    init = MazeModel(SPECS["maze5"], reference_parity_experiment("maze5").model, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    got = model.state_dict()
    assert torch.equal(got["trunk.block2.bn1.running_var"], init["trunk.block2.bn1.running_var"])
    assert torch.equal(got["trunk.block0.se.fc2.weight"], init["trunk.block0.se.fc2.weight"])
    np.testing.assert_array_equal(got["trunk.block2.bn1.running_mean"].numpy(),
                                  sd["res_blocks.1.bn1.running_mean"])
    assert torch.equal(got["trunk.block3.bn2.weight"], init["trunk.block3.bn2.weight"])
    np.testing.assert_array_equal(got["trunk.block3.bn2.running_var"].numpy(),
                                  sd["res_blocks.2.bn2.running_var"])
    assert not np.array_equal(init["trunk.block2.bn1.running_var"].numpy(), dropped)


def test_merge_checks_shapes():
    model = MazeModel(SPECS["maze5"], reference_parity_experiment("maze5").model, device="cpu")
    template = model.state_dict()
    bad = {"fc2.weight": torch.zeros(3, 1024), "fc1.bias": torch.ones(1024)}
    with pytest.raises(ValueError, match=r"shape mismatch at fc2\.weight: checkpoint "
                                         r"\(3, 1024\) vs model \(2, 1024\)"):
        merge(template, bad)
    out = merge(template, {"fc1.bias": torch.ones(1024)})
    assert list(out) == list(template)
    assert torch.equal(out["fc1.bias"], torch.ones(1024))
    assert torch.equal(out["fc2.weight"], template["fc2.weight"])


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """maze5's reference as a rich-dict ``.pth``, converted by the CLI; the
    fixture and the torch model's scores on it as the CLI loads the audio."""
    from adfmsl_torch.cli.convert_maze import main as convert_main
    from adfmsl_torch.data import (AsvspoofDataset, SyntheticSpec, generate_fixture,
                                   parse_protocol)

    root = tmp_path_factory.mktemp("convert_maze")
    tmodel = _reference("maze5", 11)
    pth = str(root / "maze5.pth")
    torch.save({"model_state_dict": tmodel.state_dict(), "epoch": 3}, pth)
    out = str(root / "ported")
    assert convert_main(["--torch_ckpt", pth, "--model_type", "maze5", "--out", out,
                         "--cut", str(CUT), "--device", "cpu"]) == 0
    info = generate_fixture(str(root / "fix"), SyntheticSpec(n_train=8, n_dev=2, n_eval=6,
                                                             duration=0.3))
    proto = parse_protocol(info["eval"]["protocol"])
    ds = AsvspoofDataset(proto, info["eval"]["audio_dir"], cut=CUT)
    audio = np.stack([ds.load(u)[0] for u in proto.utt_ids])
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(audio)).numpy()[:, 1]
    return {"root": root, "out": out, "info": info, "ids": proto.utt_ids, "ref": ref,
            "torch": tmodel}


def _scores(path, ids):
    rows = [ln.split() for ln in open(path).read().splitlines()]
    assert [r[0] for r in rows] == ids
    return np.asarray([float(r[1]) for r in rows])


def test_convert_then_evaluate_scores_like_torch(converted):
    from adfmsl_torch.cli.evaluate import main as eval_main

    c = converted
    assert sorted(os.listdir(c["out"])) == ["epoch_0", "experiment.yaml"]
    score_path = str(c["root"] / "scores.txt")
    ev = c["info"]["eval"]
    assert eval_main(["--model_type", "maze5", "--model_path", c["out"], "--protocol",
                      ev["protocol"], "--data_dir", ev["audio_dir"], "--batch_size", "4",
                      "--output", score_path, "--device", "cpu"]) == 0
    got = _scores(score_path, c["ids"])
    np.testing.assert_allclose(got, c["ref"], atol=5e-4, rtol=1e-3)


def test_emitted_yaml_loads_in_adfmsl(converted):
    from adfmsl.config.yaml_io import load_yaml as jax_load_yaml
    from adfmsl.models.port import reference_parity_experiment as jax_parity

    want = jax_parity("maze5")
    want.data.cut = CUT
    got = jax_load_yaml(os.path.join(converted["out"], "experiment.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_cli_restores_the_converted_weights(converted):
    """``--eval --restore`` scores the converted weights as the evaluate CLI
    does; one more epoch fine-tunes from them (the weights move by AdamW's
    few steps, far less than a fresh init lies from them)."""
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.models import build_model, load_checkpoint
    from adfmsl_torch.train import CheckpointManager

    c = converted
    tr, ev = c["info"]["train"], c["info"]["eval"]
    cfg = os.path.join(c["out"], "experiment.yaml")
    data = ["--config", cfg, "--train_protocol", tr["protocol"], "--train_dir",
            tr["audio_dir"], "--checkpoint_dir", c["out"], "--restore", "--batch_size", "4",
            "--device", "cpu"]
    restored = str(c["root"] / "restored.txt")
    assert cli_train.main([*data, "--eval", "--eval_protocol", ev["protocol"],
                           "--eval_dir", ev["audio_dir"], "--eval_output", restored]) == 0
    np.testing.assert_allclose(_scores(restored, c["ids"]), c["ref"], atol=5e-4, rtol=1e-3)

    _, start = load_checkpoint(c["out"])
    dv = c["info"]["dev"]
    assert cli_train.main([*data, "--num_epochs", "2", "--dev_protocol", dv["protocol"],
                           "--dev_dir", dv["audio_dir"]]) == 0
    mgr = CheckpointManager(c["out"])
    assert mgr.all_epochs()[-1] == 1 and np.isfinite(mgr.metrics(1)["train_loss"])
    _, tuned = load_checkpoint(c["out"])
    fresh = build_model(reference_parity_experiment("maze5").model, device="cpu",
                        seed=3).state_dict()
    key = "trunk.block1.conv1.weight"
    moved = float((tuned[key] - start[key]).abs().max())
    assert 0.0 < moved < 0.01 * float((fresh[key] - start[key]).abs().max())
