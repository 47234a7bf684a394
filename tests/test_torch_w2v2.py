"""The port's Wav2Vec2 encoder (``adfmsl_torch/models/w2v2.py``) against
adfmsl's flax encoder, and its local-checkpoint loader against a random-init
HF ``transformers.Wav2Vec2Model`` (nothing is downloaded; the test skips
where ``transformers`` is absent).

Encoder parity on ``W2V2Arch.tiny()``-sized archs for 'group' and for 'layer'
with ``do_stable_layer_norm``, with every hidden-state tap: f32 within
1e-5 * max(1, |ref|); bf16 within 3e-2 * max(1, |ref|), the tolerance of
tests/test_pallas.py:185. adfmsl's weights come across by
``flax_tree_to_state_dict``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adfmsl.models.w2v2 import W2V2Arch as RefArch
from adfmsl.models.w2v2 import Wav2Vec2Encoder as RefEncoder
from adfmsl.models.w2v2 import load_pretrained as ref_load_pretrained
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model
from adfmsl_torch.models.port import flax_tree_to_state_dict
from adfmsl_torch.models.pretrained import inject_pretrained_w2v2, load_w2v2_params
from adfmsl_torch.models.w2v2 import W2V2Arch, Wav2Vec2Encoder, load_pretrained

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
KINDS = {"group": ("group", False), "layer_stable": ("layer", True)}


def _arch(kind):
    norm, stable = KINDS[kind]
    return dataclasses.replace(W2V2Arch.tiny(), feat_extract_norm=norm,
                               do_stable_layer_norm=stable)


def ref_arch(arch):
    """adfmsl's arch of the port's: its fields only (the port's adds WavLM's
    ``num_buckets`` / ``max_bucket_distance``, which adfmsl has no encoder for)."""
    return RefArch(**{f.name: getattr(arch, f.name) for f in dataclasses.fields(RefArch)})


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_encoder_and_taps_match_adfmsl(kind, dtype):
    arch = _arch(kind)
    x = np.random.default_rng(7).standard_normal((2, 4000)).astype(np.float32) * 3 + 0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref_enc = RefEncoder(arch=ref_arch(arch), dtype=jdt)
    params = _np(ref_enc.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    ref, ref_hs = ref_enc.apply({"params": params}, jnp.asarray(x), output_hidden_states=True)
    enc = Wav2Vec2Encoder(arch, dtype=getattr(torch, dtype))
    enc.load_state_dict(flax_tree_to_state_dict(params), strict=True)
    with torch.no_grad():
        got, hs = enc(torch.from_numpy(x), output_hidden_states=True)
    assert len(hs) == len(ref_hs) == arch.num_layers + 1
    for a, b in zip([got, *hs], [ref, *ref_hs]):
        assert str(a.dtype) == f"torch.{b.dtype}"      # flax's promotion points
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=TOL[dtype] * max(1.0, np.abs(b).max()))


def _hf_model(kind, intermediate=128):
    transformers = pytest.importorskip("transformers")
    norm, stable = KINDS[kind]
    torch.manual_seed(3)
    cfg = transformers.Wav2Vec2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=intermediate, conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
        feat_extract_norm=norm, do_stable_layer_norm=stable, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16)
    return transformers.Wav2Vec2Model(cfg).eval()


def _old_weight_norm_spelling(sd):
    """torch's weight_norm(dim=2) names (weight_g / weight_v) in place of
    the parametrizations' (original0 / original1)."""
    base = "encoder.pos_conv_embed.conv"
    out = dict(sd)
    out[f"{base}.weight_g"] = out.pop(f"{base}.parametrizations.weight.original0")
    out[f"{base}.weight_v"] = out.pop(f"{base}.parametrizations.weight.original1")
    return out


@pytest.mark.parametrize("kind,fmt", [("group", "bin"), ("layer_stable", "bin"),
                                      ("group", "weight_g_v.pt"),
                                      ("group", "safetensors")])
def test_load_pretrained_matches_hf_and_adfmsl(kind, fmt, tmp_path):
    hf = _hf_model(kind)
    sd = hf.state_dict()
    assert "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd
    path = str(tmp_path / f"w2v2.{fmt}")
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save(_old_weight_norm_spelling(sd) if "weight_g" in fmt else sd, path)
    arch = _arch(kind)
    loaded = load_pretrained(path, arch)
    ref = flax_tree_to_state_dict(ref_load_pretrained(path, ref_arch(arch)))
    assert loaded.keys() == ref.keys()
    for k in ref:
        assert torch.equal(loaded[k], ref[k]), k
    enc = Wav2Vec2Encoder(arch, normalize_input=False)
    enc.load_state_dict(loaded, strict=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 1600)).astype(np.float32))
    with torch.no_grad():
        want = hf(x).last_hidden_state
        got = enc(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-5)


def _maze7_cfg(path=None, require=False):
    cfg = make_experiment("maze7").model
    cfg.wav2vec2.model_name = "tiny"
    cfg.wav2vec2.pretrained_path = path
    cfg.wav2vec2.require_pretrained = require
    return cfg


def test_inject_pretrained_loads_checks_shapes_and_skips(tmp_path, caplog):
    hf = _hf_model("group")
    good = str(tmp_path / "good.bin")
    torch.save(hf.state_dict(), good)
    cfg = _maze7_cfg(good)
    model = build_model(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inject_pretrained_w2v2(model, cfg.wav2vec2)
    loaded = load_w2v2_params(good, cfg.wav2vec2)
    for k, v in model.state_dict().items():
        if k.startswith("wav2vec2."):
            assert torch.equal(v, loaded[k[len("wav2vec2."):]]), k
        else:
            assert torch.equal(v, before[k]), k          # nothing else touched

    wide = str(tmp_path / "wide.bin")                   # feed-forward 256, not 128
    torch.save(_hf_model("group", intermediate=256).state_dict(), wide)
    with pytest.raises(ValueError, match="shape_mismatch"):
        inject_pretrained_w2v2(model, _maze7_cfg(wide).wav2vec2)

    missing = str(tmp_path / "missing.bin")
    with caplog.at_level("WARNING"):
        assert inject_pretrained_w2v2(model, _maze7_cfg(missing).wav2vec2) is model
    assert "using random wav2vec2 init" in caplog.text
    with pytest.raises(FileNotFoundError):
        inject_pretrained_w2v2(model, _maze7_cfg(missing, require=True).wav2vec2)
    with pytest.raises(FileNotFoundError):
        inject_pretrained_w2v2(model, _maze7_cfg(None, require=True).wav2vec2)
    # a .msgpack holding an empty map reads as an empty tree: every key is missing
    msgpack = tmp_path / "w.msgpack"
    msgpack.write_bytes(b"\x80")
    with pytest.raises(ValueError, match=r"missing=\['encoder_layer_norm.bias'"):
        inject_pretrained_w2v2(model, _maze7_cfg(str(msgpack)).wav2vec2)
