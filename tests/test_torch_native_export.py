"""adfmsl's native Wav2Vec2 export (``models/pretrained.py``: ``save_native`` /
``load_native``, the ``.msgpack`` branch of ``load_w2v2_params``;
``utils/flax_msgpack.py``), ``cli.convert``, and ``ops/bn_act.py``'s
``BNAct``, against adfmsl.

- The port's writer produces ``flax.serialization.msgpack_serialize``'s bytes
  for a tiny encoder tree and for a tree of every leaf type flax writes, also
  with leaves chunked (``MAX_CHUNK_SIZE`` lowered on both sides); either
  package reads the other's file (leaves bit for bit).
- A ``.msgpack`` ``wav2vec2.pretrained_path`` loads into maze7 'tiny' with
  logits equal to the ``.bin`` path's (bit for bit: the same weights).
- ``cli.convert --verify --device cpu`` returns 0 and writes the bytes of
  adfmsl's convert CLI from the same HF checkpoint.
- ``BNAct``'s values, gradients and running statistics against adfmsl's
  ``BNAct`` for 'relu', 'leaky' and 'selu', train and eval: f32 within
  1e-5 * max(1, |ref|); bf16 (both sides narrowing to bf16) within the
  bf16 tolerance tests/test_bn_act.py states, 2e-2 * max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from adfmsl_torch.utils import flax_msgpack


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_tree():
    """adfmsl's encoder tree at ``W2V2Arch.tiny()`` (shapes from
    ``eval_shape``, seeded values)."""
    from adfmsl.models.w2v2 import W2V2Arch, Wav2Vec2Encoder

    enc = Wav2Vec2Encoder(arch=W2V2Arch.tiny())
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(3), jnp.zeros((1, 800)))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                        shapes["params"])


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def test_writer_produces_flax_bytes(monkeypatch):
    tree = _tiny_tree()
    assert flax_msgpack.packb(tree) == flax.serialization.msgpack_serialize(tree)
    rng = np.random.default_rng(0)
    mixed = {"z": {"f16": np.ones((2, 3), np.float16), "i64": np.arange(-5, 5),
                   "scalar": np.float32(2.5), "none": None, "flag": True, "n": -70000,
                   "big": 2 ** 40, "x": 0.25, "s": "s" * 40, "b": b"\x00\x01",
                   "list": [np.zeros(2, np.int8), 3, "t"]},
             "a": {"empty": np.zeros((0, 4), np.float32),
                   "wide": rng.standard_normal(70000).astype(np.float32)}}
    assert flax_msgpack.packb(mixed) == flax.serialization.msgpack_serialize(mixed)
    _leaves_equal(flax_msgpack.unpackb(flax.serialization.msgpack_serialize(mixed)),
                  flax.serialization.msgpack_restore(flax_msgpack.packb(mixed)))
    # leaves above the chunk size (2**30 bytes in both packages) become
    # flax's chunked maps: lowered here so that small leaves take that form
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 256)
    raw = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    assert flax_msgpack.packb(tree) == raw
    _leaves_equal(flax_msgpack.unpackb(raw), tree)


def test_either_package_reads_the_others_file(tmp_path):
    from adfmsl.models.pretrained import load_native as jax_load
    from adfmsl.models.pretrained import save_native as jax_save
    from adfmsl_torch.models.pretrained import load_native, save_native

    tree = _tiny_tree()
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "adfmsl.msgpack")
    save_native(tree, ours)
    jax_save(tree, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    _leaves_equal(jax_load(ours, tree), tree)
    _leaves_equal(load_native(theirs, tree), tree)
    _leaves_equal(load_native(theirs), jax_load(theirs))
    # with a template, a key of the template missing from the file raises
    # (flax from_bytes) and keys beyond it are dropped
    extra = {**tree, "more": {"w": np.zeros(2, np.float32)}}
    with pytest.raises(ValueError, match="more"):
        load_native(theirs, extra)
    with pytest.raises(ValueError, match="more"):
        jax_load(theirs, extra)
    _leaves_equal(load_native(ours, {"feature_projection": tree["feature_projection"]}),
                  {"feature_projection": tree["feature_projection"]})


def _hf_checkpoint(tmp_path):
    """A random HF ``Wav2Vec2Model`` checkpoint of the 'tiny' arch, saved as a
    torch ``.bin``."""
    from adfmsl_torch.models.w2v2 import W2V2Arch
    from torch_ref_nets import hf_layout_state_dict

    path = str(tmp_path / "hf.bin")
    torch.save(hf_layout_state_dict(W2V2Arch.tiny(), seed=3), path)
    return path


def test_msgpack_pretrained_path_equals_bin(tmp_path):
    from adfmsl_torch.config import make_experiment
    from adfmsl_torch.models import build_model
    from adfmsl_torch.models.pretrained import inject_pretrained_w2v2, save_native
    from adfmsl_torch.models.w2v2 import W2V2Arch, port_hf_state_dict, read_hf_state_dict

    hf = _hf_checkpoint(tmp_path)
    native = str(tmp_path / "w.msgpack")
    save_native(port_hf_state_dict(read_hf_state_dict(hf), W2V2Arch.tiny()), native)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4000))
                         .astype(np.float32))
    logits = {}
    for tag, path in (("bin", hf), ("msgpack", native)):
        cfg = make_experiment("maze7").model
        cfg.wav2vec2.model_name, cfg.wav2vec2.pretrained_path = "tiny", path
        model = inject_pretrained_w2v2(build_model(cfg, device="cpu", seed=0), cfg.wav2vec2)
        with torch.inference_mode():
            logits[tag] = model.eval()(x)["logits"]
    assert torch.isfinite(logits["bin"]).all()
    assert torch.equal(logits["msgpack"], logits["bin"])


def test_convert_cli_writes_adfmsls_file(tmp_path, capsys):
    from adfmsl.cli.convert import main as jax_convert
    from adfmsl_torch.cli.convert import main as port_convert

    hf = _hf_checkpoint(tmp_path)
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "adfmsl.msgpack")
    assert port_convert(["--torch_ckpt", hf, "--arch", "tiny", "--out", ours, "--verify",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"converted {hf} -> {ours}" in out and "round-trip max abs err: 0.00e+00" in out
    assert jax_convert(["--torch_ckpt", hf, "--arch", "tiny", "--out", theirs]) == 0
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def _bn_act_case(act, train, dtype, seed=0):
    """adfmsl's and the port's BNAct on the same (4, 37, 24) input, weights
    and running statistics: outputs, gradients of sum(y^2)/2 + sum(y) with
    respect to x, scale and bias, and the running statistics after."""
    from adfmsl.ops.bn_act import BNAct as RefBNAct
    from adfmsl_torch.ops import BNAct

    c = 24
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((4, 37, c)) + 0.5).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    ref = RefBNAct(c, act=act, dtype=jdt)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt), train=True)
    v = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3 + 1.0, v)

    def loss(params, xx):
        y, mut = ref.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                           train=train, mutable=["batch_stats"])
        yf = y.astype(jnp.float32)
        return 0.5 * (yf * yf).sum() + yf.sum(), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x, jdt))
    mod = BNAct(c, act=act, dtype=tdt).train(train)
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(mod, name).copy_(torch.from_numpy(v["params"][name]))
        for name in ("mean", "var"):
            getattr(mod, name).copy_(torch.from_numpy(v["batch_stats"][name]))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    yt = mod(xt)
    assert yt.dtype == tdt
    yf = yt.float()
    (0.5 * (yf * yf).sum() + yf.sum()).backward()
    pairs = {"y": (yt, y), "dx": (xt.grad, gx), "dscale": (mod.scale.grad, gp["scale"]),
             "dbias": (mod.bias.grad, gp["bias"]), "mean": (mod.mean, stats["mean"]),
             "var": (mod.var, stats["var"])}
    return {k: (a.detach().float().numpy(), np.asarray(b, np.float32))
            for k, (a, b) in pairs.items()}


@pytest.mark.parametrize("act", ["relu", "leaky", "selu"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_act_matches_adfmsl(act, train, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, (got, ref) in _bn_act_case(act, train, dtype).items():
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def _saved_tensors(fn, seen=None):
    """Every tensor the autograd graph below ``fn`` keeps for its backward."""
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return []
    seen.add(fn)
    out = list(getattr(fn, "saved_tensors", ()) if hasattr(fn, "apply") and
               not fn.__class__.__name__.startswith("AccumulateGrad") else ())
    out += [getattr(fn, k) for k in dir(fn) if k.startswith("_saved_")
            and isinstance(getattr(fn, k), torch.Tensor)]
    for nxt, _ in fn.next_functions:
        out += _saved_tensors(nxt, seen)
    return out


def test_bn_act_state_maps_onto_adfmsl_and_recomputes():
    """Parameters ``scale`` / ``bias`` and buffers ``mean`` / ``var`` (adfmsl's
    params / batch_stats); the backward keeps x and (C,) vectors, no f32 copy
    of a bf16 x and no pre-activation; eval mode moves no statistic; an
    unknown activation raises."""
    from adfmsl_torch.ops import BNAct, norm_act

    mod = BNAct(8, act="selu", dtype=torch.bfloat16)
    assert [n for n, _ in mod.named_parameters()] == ["scale", "bias"]
    assert [n for n, _ in mod.named_buffers()] == ["mean", "var"]
    x = torch.randn(3, 5, 8).bfloat16().requires_grad_()
    y = mod(x)
    saved = _saved_tensors(y.grad_fn)
    assert saved and all(t.numel() <= 8 or (t.dtype == torch.bfloat16 and t.shape == x.shape)
                         for t in saved), [(t.dtype, tuple(t.shape)) for t in saved]
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    mod.eval()
    before = (mod.mean.clone(), mod.var.clone())
    mod(x)
    assert torch.equal(mod.mean, before[0]) and torch.equal(mod.var, before[1])
    with pytest.raises(ValueError, match="unknown act"):
        norm_act(x, torch.ones(8), torch.zeros(8), "gelu")
    # the in-place f32 work never writes into an f32 input or cotangent
    mod = BNAct(8, act="leaky").train()
    xf, dy = torch.randn(3, 5, 8, requires_grad=True), torch.randn(3, 5, 8)
    x0, dy0 = xf.detach().clone(), dy.clone()
    mod(xf).backward(dy)
    assert torch.equal(xf.detach(), x0) and torch.equal(dy, dy0)
