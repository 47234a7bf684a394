"""WavLM in the port's encoder (``adfmsl_torch/models/w2v2.py``, ``num_buckets``
> 0) against the plain float32 encoder of ``tests/wavlm_ref.py`` and, where
``transformers`` is installed, HF's ``WavLMModel``; on seeded random weights at
``W2V2Arch.tiny_wavlm()`` (4 heads, 32 buckets up to distance 64) and a cut of
4,000 samples (T' = 399, so every bucket is reached, the saturated ones too).

Tolerances, against the largest magnitude of the compared tensor (at least 1):
float32 1e-5, rounding (the port and the reference order their sums
differently; they read 5e-7 here); bfloat16 3e-2, ``tests/test_torch_w2v2.py``'s
for the encoder (every product's operands and result rounded to 8 bits of
mantissa, 2 layers deep; the states read 1e-2 here, maze6's scores 3.4e-3).
Without the bucket table the last state moves 0.44, with the gate at 1 0.23.
"""
import copy
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import wavlm_ref as R
from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model
from adfmsl_torch.models.port import flax_tree_to_state_dict
from adfmsl_torch.models.w2v2 import (W2V2Arch, Wav2Vec2Encoder, arch_for, dense,
                                      port_hf_state_dict, relative_position_bucket)
from adfmsl_torch.ops.dropout import dropout
from adfmsl_torch.parallel.mesh import Mesh
from adfmsl_torch.parallel.tp import param_spec, shard_params_tp
from adfmsl_torch.utils.profiling import totals

ARCH = W2V2Arch.tiny_wavlm()
CUT = 4000
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded(module, seed):
    """Every state-dict entry of ``module`` drawn from ``seed``: weights
    N / sqrt(fan in), biases 0.1 N, norms 1 + 0.1 N and 0.1 N, WavLM's bucket
    table 2 N (so the bias moves the softmax by units) and gate constants
    U(0.5, 2)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        z = torch.randn(v.shape, generator=g) if v.is_floating_point() else v
        if not v.is_floating_point():
            sd[k] = v
        elif "rel_attn_embed" in k:
            sd[k] = 2.0 * z
        elif "gru_rel_pos_const" in k:
            sd[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=g)
        elif "running_var" in k:
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif "running_mean" in k or (v.dim() == 1 and "norm" not in k and "bn" not in k):
            sd[k] = 0.1 * z
        elif v.dim() == 1:
            sd[k] = (1.0 + 0.1 * z) if k.endswith("weight") else 0.1 * z
        else:
            sd[k] = z / np.sqrt(v[0].numel())
    module.load_state_dict(sd)
    return sd


def audio(seed, n=2):
    g = torch.Generator().manual_seed(seed)
    return 0.1 * torch.randn(n, CUT, generator=g)


def close(got, ref, tol):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), (err, ref.abs().max().item())


def encoder(dtype, seed=1):
    enc = Wav2Vec2Encoder(ARCH, dtype=getattr(torch, dtype)).eval()
    return enc, seeded(enc, seed)


def tiny_maze6(dtype):
    exp = make_experiment("maze6")
    exp.model.wav2vec2.model_name = "tiny_wavlm"
    exp.model.dtype = dtype
    return exp, build_model(exp.model, device="cpu").eval()


def test_relative_position_buckets_at_the_published_sizes():
    """320 buckets up to distance 800, by hand: j - i > 0 takes the upper 160;
    distances under 80 are exact; longer ones 80 + trunc(80 log10(|r| / 80)),
    at most 159."""
    rel = torch.tensor([0, 1, -1, 79, -79, 80, -80, 799, -799, 800, -800, 1498, -1498])
    want = [0, 161, 1, 239, 79, 240, 80, 319, 159, 319, 159, 319, 159]
    assert relative_position_bucket(rel, 320, 800).tolist() == want
    assert R.bucket(rel, 320, 800).tolist() == want
    t = torch.arange(399)
    b = relative_position_bucket(t[None, :] - t[:, None], 32, 64)
    # the tiny cut reaches every bucket, the saturated 15 and 31 included, but
    # 16 (j - i > 0 starts at 1)
    assert sorted(b.unique().tolist()) == [i for i in range(32) if i != 16]


def test_arch_for_names_wavlm():
    names = make_experiment("maze6").model.wav2vec2
    assert arch_for(dataclasses.replace(names, model_name="microsoft/wavlm-large")) == \
        W2V2Arch.wavlm_large()
    assert arch_for(dataclasses.replace(names, model_name="tiny_wavlm")) == ARCH
    assert arch_for(names).num_buckets == 0
    with pytest.raises(ValueError, match="microsoft/wavlm-large"):
        arch_for(dataclasses.replace(names, model_name="microsoft/wavlm-base-plus"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_maze6_match_the_reference(dtype):
    """Every hidden state of the encoder, and maze6's scores with the
    reference's taps in place of the port's encoder."""
    enc, sd = encoder(dtype)
    x = audio(2)
    with torch.no_grad():
        _, hs = enc(x, output_hidden_states=True)
        ref = R.hidden_states(sd, x, ARCH)
    assert len(hs) == len(ref) == ARCH.num_layers + 1
    for a, b in zip(hs, ref):
        close(a, b, TOL[dtype])

    _, model = tiny_maze6(dtype)
    msd = seeded(model, 3)
    esd = {k[len("wav2vec2."):]: v for k, v in msd.items() if k.startswith("wav2vec2.")}
    with torch.no_grad():
        got = model(x)["scores"]
        states = R.hidden_states(esd, x, ARCH)
        model._w2v2_features = lambda _x: torch.cat(
            [states[min(i, len(states) - 1)] for i in model.spec.fusion_layers], -1)
        want = model(x)["scores"]
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("drop", ["table", "gate"])
def test_the_gated_bias_moves_the_states_beyond_the_bf16_tolerance(drop):
    """The reference without the bucket table (E = 0), or with the gate at 1,
    is further from the port than the bf16 tolerance: a port without the
    mechanism fails the comparison above."""
    enc, sd = encoder("float32")
    x = audio(2)
    with torch.no_grad():
        got = enc(x)
    ref = R.hidden_states(sd, x, ARCH, drop=drop)[-1]
    err = (got - ref).abs().max().item()
    assert err > 3 * TOL["bfloat16"] * max(1.0, ref.abs().max().item()), err


def test_counters_once_a_forward_and_once_a_layer():
    enc, _ = encoder("float32")
    before = totals()
    with torch.no_grad():
        enc(audio(4))
    after = totals()
    assert after.get("w2v2.relpos_bias", 0) - before.get("w2v2.relpos_bias", 0) == 1
    assert (after.get("w2v2.gated_layers", 0) - before.get("w2v2.gated_layers", 0)
            == ARCH.num_layers)


def test_train_step_gives_the_bias_gradients():
    """A train step of maze6 on 'tiny_wavlm' (encoder unfrozen), without and
    with ``remat_layers`` from the same weights: finite, non-zero gradients of
    the bucket table and of every layer's gate, the checkpointed step's equal
    to rounding (the bias's gradient sums its layers' parts in another
    order)."""
    from adfmsl_torch.train import Optimizer, TrainState, make_train_step

    exp = make_experiment("maze6")
    exp.model.wav2vec2.model_name = "tiny_wavlm"
    exp.model.dtype = "float32"
    exp.model.wav2vec2.freeze = False
    a = exp.model.architecture
    a.dropout_rate = a.fc_dropout = a.transformer_dropout = 0.0
    exp.model.spec_augment.enabled = False
    model = build_model(exp.model, device="cpu", seed=0)
    sd = seeded(model, 5)
    grads = {}
    for remat in (False, True):
        model.load_state_dict(sd)
        model.wav2vec2.remat_layers = remat
        st = TrainState(model, Optimizer.for_model(exp, model, 10, 1), seed=0)
        met = make_train_step(exp)(st, audio(6), torch.tensor([0, 1]),
                                   torch.ones(2, dtype=torch.bool), st.generators(0, 0))
        assert torch.isfinite(met["loss"]) and float(met["skipped"]) == 0.0
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if "rel_attn_embed" in n or "gru_rel_pos_linear" in n}
    assert len(grads[True]) == 1 + 2 * ARCH.num_layers
    for n, g in grads[True].items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, n
        torch.testing.assert_close(g, grads[False][n], rtol=1e-5, atol=1e-9)


def _attention_before_wavlm(self, x, dtype, dropout_rate=0.0, generator=None, bias=None,
                            row=None):
    """``SelfAttention.forward`` as it was before the relative-position path,
    verbatim (``bias`` and ``row`` taken and unused)."""
    b, t, _ = x.shape
    hd = self.head_dim
    q, k, v = (dense(x, getattr(self, n), dtype).view(b, t, self.heads, hd)
               .transpose(1, 2) for n in ("query", "key", "value"))
    q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
    w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
    w = dropout(w, dropout_rate, generator, self.training)
    o = torch.matmul(w, v).transpose(1, 2).reshape(b, t, self.heads * hd)
    return dense(o, self.out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav2vec2_path_is_unchanged(dtype):
    """The wav2vec2 tiny arch (no bias) against the same seeded encoder with
    its attention computed as before the change: bit for bit, and no counter
    moves."""
    enc = Wav2Vec2Encoder(W2V2Arch.tiny(), dtype=getattr(torch, dtype)).eval()
    seeded(enc, 7)
    x = audio(8)
    before = totals()
    with torch.no_grad():
        got = enc(x)
        for i in range(enc.arch.num_layers):
            att = getattr(enc, f"layers_{i}").attention
            att.forward = _attention_before_wavlm.__get__(att)
        want = enc(x)
    assert torch.equal(got, want)
    assert totals().get("w2v2.gated_layers", 0) == before.get("w2v2.gated_layers", 0)
    assert totals().get("w2v2.relpos_bias", 0) == before.get("w2v2.relpos_bias", 0)


def test_tensor_parallel_split_of_the_bias():
    """The bucket table's columns and the gate constants split with the heads,
    the gate's linear stays whole; two ranks' attention outputs (each with the
    bias of its own heads, row-parallel ``out``) add up to the whole layer's,
    checked in one process without collectives."""
    model = torch.nn.Module()
    model.wav2vec2 = Wav2Vec2Encoder(ARCH)
    seeded(model, 9)
    assert param_spec("wav2vec2.layers_0.attention.rel_attn_embed.weight") == 1
    assert param_spec("wav2vec2.layers_1.attention.gru_rel_pos_const") == 1
    assert param_spec("wav2vec2.layers_1.attention.gru_rel_pos_linear.weight") is None
    h = torch.randn(2, 50, ARCH.hidden_size)
    with torch.no_grad():
        enc = model.wav2vec2
        want = enc.layers_1.attention(h, torch.float32, bias=enc.position_bias(50))
        parts = []
        for r in range(2):
            m = shard_params_tp(copy.deepcopy(model), Mesh(1, 2, r, None, None))
            e = m.wav2vec2
            assert e.layers_0.attention.rel_attn_embed.weight.shape == (32, 2)
            parts.append(e.layers_1.attention(h, torch.float32, bias=e.position_bias(50)))
    out_bias = model.wav2vec2.layers_1.attention.out.bias
    close(parts[0] + parts[1] - out_bias, want, 1e-5)


def test_hf_wavlm_ported_through_port_hf_state_dict():
    """HF's ``WavLMModel`` (random init, nothing downloaded; the bucket table
    and gates redrawn larger) ported by ``port_hf_state_dict`` with its
    'wavlm.' prefix: the port's last hidden state within float32 rounding."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(3)
    cfg = transformers.WavLMConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), conv_bias=False,
        feat_extract_norm="layer", do_stable_layer_norm=True, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16, num_buckets=32, max_bucket_distance=64)
    hf = transformers.WavLMModel(cfg).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "rel_attn_embed" in n:
                p.normal_(0.0, 2.0)
            elif "gru_rel_pos" in n:
                p.uniform_(0.5, 2.0)
    sd = {"wavlm." + k: v.numpy() for k, v in hf.state_dict().items()}
    enc = Wav2Vec2Encoder(ARCH, normalize_input=False).eval()
    enc.load_state_dict(flax_tree_to_state_dict(port_hf_state_dict(sd, ARCH)), strict=True)
    x = audio(10)
    with torch.no_grad():
        close(enc(x), hf(x).last_hidden_state, TOL["float32"])
