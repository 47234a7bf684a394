"""RawNet main / main_fmsl end to end: the port's MazeModel vs adfmsl's on the
same weights and inputs, at full width (128 sinc filters, K=251, blocks
128->128->128->256->256->256->256, GRU 1024, fc1_gru 1024, FMSL 'replace' at
1024) and cut 9000, batch 2 (as test_pallas.py:152-187). Weights go adfmsl
init -> numpy -> state_dict_from_flax -> load_state_dict(strict=True).

Tolerances: f32 logits within 1e-4 * max(1, |logits|) of adfmsl's plain path;
bf16 logits through the folded trunk (K1's plain version on the CPU), and with
the K3 front end as well (its plain version against adfmsl's interpret-mode
kernel), within 3e-2 * max(1, |logits|) of adfmsl's fused paths
(test_pallas.py:185). The BN running stats are centred (mean N(0, 0.1), var
U(0.5, 2)) so the activations stay O(1), as a trained model's do: with stats
far from the data's, six gated blocks and the GRU amplify bf16 rounding until
adfmsl's own bf16 paths disagree with its f32 path by more than 3e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.config import make_experiment as jax_experiment
from adfmsl.models import build_model as jax_build_model
from adfmsl_torch.cli import evaluate
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import SPECS, build_model, state_dict_from_flax
from adfmsl_torch.models import rawnet as port_rawnet
from adfmsl_torch.models import sincnet as port_sincnet
from adfmsl_torch.models.blocks import GRU
from test_torch_telemetry import MODEL_STAGES, check_model_stages

CUT = 9000
NAMES = ["main", "main_fmsl"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# (dtype, fused_eval_trunk, fused_eval_frontend)
PATHS = {"f32": ("float32", False, False), "bf16_trunk": ("bfloat16", True, False),
         "bf16_trunk_frontend": ("bfloat16", True, True)}


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _centred_stats(rng, batch_stats):
    def draw(path, a):
        if str(getattr(path[-1], "key", path[-1])) == "mean":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _experiment(make, name, path):
    dtype, trunk, frontend = PATHS[path]
    exp = make(name)
    exp.data.cut = CUT
    exp.model.dtype = dtype
    exp.model.extra["fused_eval_trunk"] = trunk
    exp.model.extra["fused_eval_frontend"] = frontend
    return exp


@pytest.fixture(scope="module")
def variables():
    """Per model: adfmsl variables with centred BN running stats, the input
    batch, and adfmsl's logits on each path. main's fc2 is scaled so its
    logits are O(1) and the tolerances bite (main_fmsl's are s*cos, s=32)."""
    rng = np.random.default_rng(2025)
    out = {}
    for name in NAMES:
        x = rng.standard_normal((2, CUT)).astype(np.float32)
        model = jax_build_model(_experiment(jax_experiment, name, "f32").model)
        v = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x))
        params = _numpy_tree(v["params"])
        stats = _centred_stats(rng, _numpy_tree(v["batch_stats"]))
        if "fc2" in params:
            params["fc2"]["kernel"] = params["fc2"]["kernel"] * 8.0
        logits = {}
        for path in PATHS:
            m = jax_build_model(_experiment(jax_experiment, name, path).model)
            res = jax.jit(lambda v, x: m.apply(v, x, train=False))(
                {"params": params, "batch_stats": stats}, jnp.asarray(x))
            logits[path] = np.asarray(res["logits"], np.float32)
        out[name] = {"x": x, "params": params, "stats": stats, "logits": logits}
    return out


def _port(name, v, path):
    model = build_model(_experiment(make_experiment, name, path).model, device="cpu")
    model.load_state_dict(state_dict_from_flax(v["params"], v["stats"], name),
                          strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(v["x"]))
    assert out["scores"].shape == (2,) and out["features"].shape == (2, 1024)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_f32_logits_match_adfmsl(variables, name):
    v = variables[name]
    ref = v["logits"]["f32"]
    assert 0.5 < np.abs(ref).max() < 50          # O(1) logits: the check bites
    got = _port(name, v, "f32")["logits"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("path", ["bf16_trunk", "bf16_trunk_frontend"])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_fused_logits_match_adfmsl(variables, name, path):
    v = variables[name]
    ref = v["logits"][path]
    got = _port(name, v, path)["logits"].float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", NAMES)
def test_scores_follow_the_spec(variables, name):
    """main scores log-softmax[:, 1]; main_fmsl the raw logit[:, 1]."""
    out = _port(name, variables[name], "f32")
    logits = out["logits"]
    want = (torch.log_softmax(logits, dim=-1)[:, 1] if name == "main"
            else logits[:, 1])
    assert SPECS[name].score == ("log_softmax" if name == "main" else "logit")
    torch.testing.assert_close(out["scores"], want, rtol=0, atol=0)


@pytest.mark.parametrize("name,n_params,n_stats", [("main", 80, 26),
                                                   ("main_fmsl", 85, 28)])
def test_state_dict_covers_every_flax_leaf(variables, name, n_params, n_stats):
    v = variables[name]
    assert len(jax.tree.leaves(v["params"])) == n_params
    assert len(jax.tree.leaves(v["stats"])) == n_stats
    sd = state_dict_from_flax(v["params"], v["stats"], name)
    assert len(sd) == n_params + n_stats + n_stats // 2   # + num_batches_tracked
    gru = v["params"]["encoder"]["gru"]["cell"]
    for g in ("ir", "iz", "in", "hr", "hz", "hn"):
        np.testing.assert_array_equal(sd[f"encoder.gru.cell.{g}.weight"].numpy(),
                                      gru[g]["kernel"].T)
        assert (f"encoder.gru.cell.{g}.bias" in sd) == (g not in ("hr", "hz"))
    assert tuple(sd["encoder.gru.cell.ir.weight"].shape) == (1024, 256)
    assert tuple(sd["encoder.block2.downsample.weight"].shape) == (256, 128, 1)
    assert tuple(sd["encoder.block5.conv2.weight"].shape) == (256, 256, 3)
    assert tuple(sd["encoder.fc_attention5.weight"].shape) == (256, 256)
    assert "encoder.block0.bn1.weight" not in sd
    assert "encoder.block3.downsample.weight" not in sd
    assert "encoder.bn_before_gru.running_var" in sd
    if name == "main":
        assert tuple(sd["fc2.weight"].shape) == (2, 1024) and "fc1.weight" not in sd
    else:
        assert tuple(sd["fmsl.prototypes"].shape) == (3, 1024)
        assert not any(k.startswith(("fc1.", "fc2.")) for k in sd)


def test_gru_matches_adfmsl():
    """The GRU alone at f32: adfmsl's hoisted scan vs the port's loop."""
    from adfmsl.models.blocks import GRU as JaxGRU

    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    jgru = JaxGRU(16, layers=1, return_sequences=False)
    p = _numpy_tree(jgru.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    for g in ("ir", "iz", "in", "hn"):                     # non-zero biases
        p["cell"][g]["bias"] = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(jgru.apply({"params": p}, jnp.asarray(x)))
    gru = GRU(32, 16)
    sd = state_dict_from_flax({"gru": p}, {}, "main")
    gru.load_state_dict({k[len("gru."):]: t for k, t in sd.items()}, strict=True)
    with torch.inference_mode():
        got = gru(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,flags,frontend,trunk", [
    ("bfloat16", ["--fused_frontend"], True, True),
    ("bfloat16", [], False, True),
    ("bfloat16", ["--fused_frontend", "--no_fused_frontend"], False, True),
    ("bfloat16", ["--fused_frontend", "--no_fused_trunk"], True, False),
    ("float32", ["--fused_frontend"], False, False),        # parity config
])
def test_cli_fused_rule(dtype, flags, frontend, trunk):
    """adfmsl's rule (cli/evaluate.py:105-115) for both extras."""
    args = evaluate.build_parser().parse_args(
        ["--model_type", "main", "--protocol", "p", "--data_dir", "d", *flags])
    exp = make_experiment("main")
    exp.model.dtype = dtype
    evaluate.set_fused_extras(exp, SPECS["main"],
                              fused_frontend=args.fused_frontend
                              and not args.no_fused_frontend,
                              fused_trunk=not args.no_fused_trunk)
    assert exp.model.extra["fused_eval_frontend"] is frontend
    assert exp.model.extra["fused_eval_trunk"] is trunk


def test_cli_main_fmsl_fused_frontend_on_cpu(fixture_dir, tmp_path, capsys,
                                             monkeypatch):
    """The evaluate CLI scores main_fmsl with --fused_frontend on the CPU: one
    finite score per protocol utterance in protocol order, the EER printed,
    and every batch through K3's and K1's wrappers (their plain versions
    here): once per batch, and once per block per batch."""
    calls = {"k3": 0, "k1": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_sincnet, "sinc_abs_pool_fused",
                        spy("k3", port_sincnet.sinc_abs_pool_fused))
    monkeypatch.setattr(port_rawnet, "resblock_eval", spy("k1", port_rawnet.resblock_eval))
    ev = fixture_dir["eval"]
    out = tmp_path / "s.txt"
    batch = 6
    rc = evaluate.main(["--model_type", "main_fmsl", "--protocol", ev["protocol"],
                        "--data_dir", ev["audio_dir"], "--output", str(out),
                        "--batch_size", str(batch), "--cut", str(CUT),
                        "--device", "cpu", "--fused_frontend", "--seed", "4"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ev["utt_ids"]
    assert np.isfinite([float(ln.split()[1]) for ln in lines]).all()
    assert "'eer'" in capsys.readouterr().out
    n_batches = -(-len(ev["utt_ids"]) // batch)
    assert calls == {"k3": n_batches, "k1": 6 * n_batches}


@pytest.mark.parametrize("name", ["main", "main_fmsl", "maze5"])
def test_forward_enters_the_model_stage_spans_in_order(name):
    """RawNet's encoder (sinc front end, blocks, GRU) is one front-end span
    and it has no trunk span; maze5's sinc front end, trunk and head are three."""
    exp = make_experiment(name)
    exp.data.cut = CUT
    names = MODEL_STAGES[::2] if name.startswith("main") else MODEL_STAGES
    check_model_stages(build_model(exp.model, device="cpu"), torch.zeros((1, CUT)), names)
