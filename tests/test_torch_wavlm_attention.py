"""K6 (WavLM's gated relative-position attention at eval in one kernel,
``adfmsl_torch.ops.wavlm_attention``) against the composition it stands in
for (``models/w2v2.py:SelfAttention.forward``, WavLM's branch).

On the CPU, at ``W2V2Arch.tiny_wavlm()`` with two heads of 64 (K6's head dim):
the plain version equals the composition bit for bit in float32 and in
bfloat16 (tolerance 0 in both: it runs the composition's operations, in the
same order, on the same operands; the bias gathered from the row holds the
table's values), at T = 1, below one key tile and at an odd T past it; the
per-distance row gathers ``position_bias`` exactly; the dispatch rule (eval,
grad off, no dropout, bf16, a card, head dim 64, any T) and the counter staying 0
wherever the composition runs; an encoder forward through K6's path (the
plain version on the CPU) equal to the composition's without building the
table; the tensor-parallel split of the row; the wrapper's checks; and
``composition_gap``'s bound holding a flash-form emulation of the kernel's
rounding points and refusing a bias shifted by one distance.

On a card (marker ``cuda``; no JAX here): the kernel within
``composition_gap``'s bound of its plain version, and its layer within the
bf16 tolerance of the composition's, at WavLM-Large's cell shape (16, 16,
1,499, 64), at maze6's T' 201, at T' in {1, 63, 64, 65, 127, 129} and at T'
6,000 (two minutes of audio), one count a launch; on operands whose scores
are exact; no tensor of a score matrix's size made on K6's path; the
counter on an encoder's eval, training and float32 forwards:
    python -m pytest --noconftest -q tests/test_torch_wavlm_attention.py -m cuda
"""
import copy
import dataclasses
import math
import types

import pytest
import torch

from adfmsl_torch.models.w2v2 import (W2V2Arch, Wav2Vec2Encoder, dense,
                                      relative_position_bucket)
from adfmsl_torch.ops import wavlm_attention as k6
from adfmsl_torch.parallel.mesh import Mesh
from adfmsl_torch.parallel.tp import shard_params_tp
from adfmsl_torch.utils.profiling import totals

COUNTER = "w2v2.fused_attention"
ARCH = dataclasses.replace(W2V2Arch.tiny_wavlm(), hidden_size=128, num_heads=2)
TOL_BF16 = 3e-2          # tests/test_torch_wavlm.py's bf16 tolerance for the encoder


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _count():
    return totals().get(COUNTER, 0)


def _encoder(dtype=torch.float32, arch=ARCH, seed=0):
    """An encoder with a bucket table of N(0, 2) (the bias moves the softmax by
    units) and gate constants in [0.5, 2]."""
    torch.manual_seed(seed)
    enc = Wav2Vec2Encoder(arch, dtype=dtype).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for i in range(arch.num_layers):
            att = getattr(enc, f"layers_{i}").attention
            if hasattr(att, "gru_rel_pos_const"):
                att.gru_rel_pos_const.copy_(0.5 + 1.5 * torch.rand(
                    att.gru_rel_pos_const.shape, generator=g))
        if arch.num_buckets:
            w = enc.layers_0.attention.rel_attn_embed.weight
            w.copy_(2.0 * torch.randn(w.shape, generator=g))
    return enc


def _operands(att, h, dtype):
    """The K6 operands of layer ``att`` for its input ``h``: q, k, v as the
    projections' (B, T, H * 64) outputs, the gate (B, H, T)."""
    q, k, v = (dense(h, getattr(att, n), dtype) for n in ("query", "key", "value"))
    return q, k, v, att.gate(h, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 63, 131])
def test_plain_equals_the_composition(dtype, t):
    """The plain version through the out projection equals the layer's
    composition bit for bit (T = 1, below one key tile, odd past it)."""
    dt = getattr(torch, dtype)
    enc = _encoder(dt)
    att = enc.layers_1.attention
    h = torch.randn(2, t, ARCH.hidden_size, generator=torch.Generator().manual_seed(t))
    with torch.no_grad():
        want = att(h, dt, bias=enc.position_bias(t))
        o = k6.wavlm_attention_plain(*_operands(att, h, dt), enc.relative_position_row(t))
        got = dense(o, att.out, dt)
    assert o.shape == (2, t, ARCH.hidden_size) and o.dtype == dt
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["tiny_wavlm", "wavlm_large"])
@pytest.mark.parametrize("t", [1, 63, 399])
def test_the_row_gathers_position_bias(arch, t):
    """``bias_from_row`` of the per-distance row is the bucket table's entry
    of ``relative_position_bucket(j - i)``, exactly; the row is (H, 2t - 1)."""
    a = getattr(W2V2Arch, arch)()
    table = torch.randn(a.num_buckets, a.num_heads, generator=torch.Generator().manual_seed(t))
    enc = types.SimpleNamespace(arch=a, layers_0=types.SimpleNamespace(
        attention=types.SimpleNamespace(rel_attn_embed=types.SimpleNamespace(weight=table))))
    enc.relative_position_row = types.MethodType(Wav2Vec2Encoder.relative_position_row, enc)
    row = enc.relative_position_row(t)
    assert row.shape == (a.num_heads, 2 * t - 1) and row.is_contiguous()
    pos = torch.arange(t)
    bucket = relative_position_bucket(pos[None, :] - pos[:, None], a.num_buckets,
                                      a.max_bucket_distance)
    want = table[bucket].permute(2, 0, 1)
    assert torch.equal(k6.bias_from_row(row, t), want)
    assert torch.equal(Wav2Vec2Encoder.position_bias(enc, t), want)


CARD = types.SimpleNamespace(is_cuda=True, shape=(2, 1499, 128))   # what the rule reads
HOST = types.SimpleNamespace(is_cuda=False, shape=(2, 1499, 128))


@pytest.mark.parametrize("case", ["eval_bf16_card", "train", "grad_enabled", "float32", "cpu",
                                  "wav2vec2", "head_dim_32", "long_t"])
def test_dispatch(case):
    """``SelfAttention.fused``: K6 only for WavLM's form at eval (training is
    where dropout acts) with grad off, bf16, on a card, at head dim 64, and
    at any T (here ten minutes of audio too)."""
    arch = {"wav2vec2": dataclasses.replace(ARCH, num_buckets=0),
            "head_dim_32": dataclasses.replace(ARCH, num_heads=4)}.get(case, ARCH)
    att = _encoder(arch=arch).layers_1.attention
    x = {"cpu": HOST, "long_t": types.SimpleNamespace(
        is_cuda=True, shape=(2, 30_000, 128))}.get(case, CARD)
    if case == "train":
        att.train()
    dt = torch.float32 if case == "float32" else torch.bfloat16
    with torch.set_grad_enabled(case == "grad_enabled"):
        got = att.fused(x, dt)
    assert got == (case in ("eval_bf16_card", "long_t"))


@pytest.mark.parametrize("mode", ["eval_bf16", "eval_f32", "eval_grad", "train", "dropout"])
def test_the_composition_runs_and_the_counter_stays_0(mode, monkeypatch):
    """On the CPU, at eval, with grad on, in training and with the attention
    weights' dropout the encoder builds the table and runs the composition:
    no K6 count, no row handed on."""
    dt = torch.float32 if mode == "eval_f32" else torch.bfloat16
    enc = _encoder(dt)
    if mode in ("train", "dropout"):
        enc.train()
    rows = []
    real = k6.wavlm_attention
    monkeypatch.setattr(k6, "wavlm_attention", lambda *a: rows.append(1) or real(*a))
    x = 0.1 * torch.randn(2, 4000, generator=torch.Generator().manual_seed(3))
    before, gated = _count(), totals().get("w2v2.gated_layers", 0)
    with torch.set_grad_enabled(mode in ("eval_grad", "train", "dropout")):
        if mode == "dropout":
            h = torch.randn(2, 30, ARCH.hidden_size)
            w = enc.layers_1.attention(h, dt, 0.1, torch.Generator().manual_seed(0),
                                       bias=enc.position_bias(30))
            assert w.shape == h.shape
        else:
            enc(x)
    assert _count() == before and rows == []
    assert totals()["w2v2.gated_layers"] == gated + (1 if mode == "dropout" else ARCH.num_layers)


def _force_k6(monkeypatch):
    """Take K6's path wherever the rule holds but for the device (the plain
    version then runs on the CPU); the (H, T, T) table must not be built."""
    from adfmsl_torch.models.w2v2 import SelfAttention

    def fused(self, x, dtype):
        return (hasattr(self, "gru_rel_pos_linear") and dtype == torch.bfloat16
                and not torch.is_grad_enabled() and not self.training)

    def no_table(self, t):
        raise AssertionError("the (H, T, T) table was built on K6's path")

    monkeypatch.setattr(SelfAttention, "fused", fused)
    monkeypatch.setattr(Wav2Vec2Encoder, "position_bias", no_table)


def test_encoder_forward_through_k6_path_equals_the_composition(monkeypatch):
    """A bf16 eval forward through K6's path (the row, the plain version on
    the CPU) gives the composition's last state and every layer's bit for
    bit; each layer counts as gated, the row once, and the plain version
    counts no launch."""
    enc = _encoder(torch.bfloat16)
    x = 0.1 * torch.randn(2, 4000, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want, want_states = enc(x, output_hidden_states=True)
        _force_k6(monkeypatch)
        before = dict(totals())
        got, states = enc(x, output_hidden_states=True)
    after = totals()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(states, want_states))
    assert after["w2v2.gated_layers"] == before["w2v2.gated_layers"] + ARCH.num_layers
    assert after["w2v2.relpos_bias"] == before["w2v2.relpos_bias"] + 1
    assert after.get(COUNTER, 0) == before.get(COUNTER, 0)


def test_a_row_where_k6_does_not_take_the_call_raises():
    """The row is K6's operand alone: a layer handed one where ``fused`` does
    not hold (here the CPU) raises rather than running anything else."""
    enc = _encoder(torch.bfloat16)
    h = torch.randn(1, 20, ARCH.hidden_size)
    with torch.no_grad(), pytest.raises(ValueError, match="K6 does not take"):
        enc.layers_1.attention(h, torch.bfloat16, row=enc.relative_position_row(20))


def test_tensor_parallel_split_slices_the_row():
    """Split over two ranks, each rank's row is the whole row's rows of its
    own heads, and its layer through the plain version adds up (with the
    row-parallel ``out``) to the whole layer's."""
    model = torch.nn.Module()
    model.wav2vec2 = _encoder()
    t = 50
    h = torch.randn(2, t, ARCH.hidden_size, generator=torch.Generator().manual_seed(5))
    enc = model.wav2vec2
    with torch.no_grad():
        row = enc.relative_position_row(t)
        att = enc.layers_1.attention
        want = dense(k6.wavlm_attention_plain(*_operands(att, h, torch.float32), row),
                     att.out, torch.float32)
        parts = []
        for r in range(2):
            e = shard_params_tp(copy.deepcopy(model), Mesh(1, 2, r, None, None)).wav2vec2
            a = e.layers_1.attention
            assert torch.equal(e.relative_position_row(t), row[r:r + 1])
            o = k6.wavlm_attention_plain(*_operands(a, h, torch.float32),
                                         e.relative_position_row(t))
            parts.append(torch.matmul(o, a.out.weight.t()))
    torch.testing.assert_close(parts[0] + parts[1] + att.out.bias, want, rtol=0, atol=1e-5)


def _random_operands(b, t, heads, seed, dev="cpu"):
    """q (as projected: a quarter once divided by 8), k, v, the gate and the row."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (s * torch.randn(b, t, heads * 64, generator=g) for s in (2.0, 0.25, 1.0))
    gate = 1 + torch.rand(b, heads, t, generator=g)
    row = torch.randn(heads, 2 * t - 1, generator=g)
    return [x.to(dev) for x in (q.bfloat16(), k.bfloat16(), v.bfloat16(), gate, row)]


def test_wrapper_runs_plain_on_cpu_and_checks_operands():
    q, k, v, gate, row = _random_operands(1, 9, 2, 0)
    assert torch.equal(k6.wavlm_attention(q, k, v, gate, row),
                       k6.wavlm_attention_plain(q, k, v, gate, row))
    with pytest.raises(ValueError, match="unsupported device"):
        k6.wavlm_attention(*(x.to("meta") for x in (q, k, v, gate, row)))
    bad = {"q_f32": (q.float(), k, v, gate, row), "width_96": (q[..., :96], k, v, gate, row),
           "row_short": (q, k, v, gate, row[:, 1:]), "gate_f16": (q, k, v, gate.half(), row),
           "k_odd_stride": (q, torch.zeros(1, 9, 129, dtype=torch.bfloat16)[..., :128], v, gate,
                                row)}
    for name, ops in bad.items():
        with pytest.raises(ValueError):
            k6._check_operands(*ops)
    with pytest.raises(ValueError, match="T >= 1"):
        k6._check_operands(torch.empty(1, 0, 64, dtype=torch.bfloat16), None, None, None, None)


def _flash_form(q, k, v, gate, row, bn=128):
    """K6's rounding points in plain PyTorch: q divided by 8, the scores
    rounded to bf16, the f32 bias, an online softmax over key tiles of ``bn``
    in exp2, the weights rounded to bf16 before the division by the row sum."""
    b, t, width = q.shape
    heads = row.shape[0]
    qh, kh, vh = (x.view(b, t, heads, width // heads).transpose(1, 2).float()
                  for x in (k6.scale_query(q, width // heads), k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)).bfloat16().float()
    x = torch.addcmul(s, gate[..., None], k6.bias_from_row(row, t))
    m = torch.full(x.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(b, heads, t, width // heads)
    log2e = 1.4426950408889634
    for j0 in range(0, t, bn):
        xs = x[..., j0:j0 + bn]
        mn = torch.maximum(m, xs.amax(-1, keepdim=True))
        scale = torch.exp2((m - mn) * log2e)
        p = torch.exp2(xs * log2e - mn * log2e)
        l = l * scale + p.sum(-1, keepdim=True)
        o = o * scale + torch.matmul(p.bfloat16().float(), vh[:, :, j0:j0 + bn])
        m = mn
    return (o / l).bfloat16().transpose(1, 2).reshape(b, t, width)


@pytest.mark.parametrize("t", [1, 65, 300])
def test_composition_gap_holds_the_flash_form_and_refuses_a_shifted_bias(t):
    q, k, v, gate, row = _random_operands(2, t, 2, t)
    gap = k6.composition_gap(_flash_form(q, k, v, gate, row), q, k, v, gate, row)
    assert gap["max_gap_over_bound"] <= 1.0, gap
    if t > 1:
        shifted = _flash_form(q, k, v, gate, torch.roll(row, 1, -1))
        assert k6.composition_gap(shifted, q, k, v, gate, row)["max_gap_over_bound"] > 4


# ---------------------------------------------------------------- on a card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K6 kernel has no CPU form")


def _launch_checked(q, k, v, gate, row):
    before, launches = _count(), k6.wavlm_attention.launches
    out = k6.wavlm_attention(q, k, v, gate, row)
    torch.cuda.synchronize()
    assert _count() == before + 1 and k6.wavlm_attention.launches == launches + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    return out


CARD_SHAPES = [(16, 16, 1499), (2, 16, 201), (2, 4, 1), (2, 4, 63), (2, 4, 64), (2, 4, 65),
               (2, 4, 127), (2, 4, 129), (1, 2, 6000)]
CARD_IDS = ["cell_b16_t1499", "maze6_t201", "t1", "t63", "t64", "t65", "t127", "t129",
            "t6000"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,t", CARD_SHAPES, ids=CARD_IDS)
def test_kernel_within_bound_of_its_plain_version(b, heads, t):
    """Random operands (scores of a few units, gates in [1, 2], a N(0, 1)
    row): every element within ``composition_gap``'s bound of the plain
    version, one count a launch."""
    _card()
    ops = _random_operands(b, t, heads, t, "cuda")
    out = _launch_checked(*ops)
    gap = k6.composition_gap(out, *ops)
    print(gap)
    assert gap["max_gap_over_bound"] <= 1.0, gap


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1499])
def test_kernel_on_exact_scores(t):
    """q / 8 and k in {0, +-1/8, +-1/4}: every product a multiple of 1/64 and
    every score below 4 in magnitude, so the scores are exact in f32 and bf16
    on both sides; gates and the row dyadic, so the biased scores are exact
    too. What is left is each side's weight and output rounding."""
    _card()
    g = torch.Generator().manual_seed(t)
    vals = torch.tensor([0.0, 0.125, -0.125, 0.25, -0.25])
    q, k = (s * vals[torch.randint(0, 5, (2, t, 256), generator=g)] for s in (8, 1))
    v = torch.randn(2, t, 256, generator=g)
    gate = torch.tensor([0.5, 1.0, 1.5, 2.0])[torch.randint(0, 4, (2, 4, t), generator=g)]
    row = torch.randint(-64, 65, (4, 2 * t - 1), generator=g) / 16.0
    ops = [x.cuda() for x in (q.bfloat16(), k.bfloat16(), v.bfloat16(), gate, row)]
    out = _launch_checked(*ops)
    gap = k6.composition_gap(out, *ops)
    print(gap)
    assert gap["max_gap_over_bound"] <= 1.0, gap


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(16, 1499), (2, 201)], ids=["cell", "maze6_t201"])
def test_layer_through_k6_within_bf16_of_the_composition(b, t):
    """WavLM-Large's layer (16 heads of 64) at eval: the layer output with
    K6 against the composition's, within the bf16 tolerance; K6's path makes
    no (B, H, T, T) tensor: no operation of the layer's forward allocates
    more than one of its (B, T, 1024) bf16 activations (the input's bf16
    copy, q, k, v, K6's output, the out projection's) or a bf16 copy of a
    (1024, 1024) weight (the dense products cast theirs), the larger of
    which is smaller than one bf16 score matrix at each shape."""
    _card()
    from torch.utils._python_dispatch import TorchDispatchMode

    from adfmsl_torch.models.w2v2 import SelfAttention

    class Largest(TorchDispatchMode):
        """The largest storage an operation allocates inside the mode, in
        bytes (a view's storage is its input's, and is not counted)."""
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            seen = {x.untyped_storage().data_ptr() for x in (*args, *kwargs.values())
                    if isinstance(x, torch.Tensor)}
            out = func(*args, **kwargs)
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() not in seen:
                    self.nbytes = max(self.nbytes, x.untyped_storage().nbytes())
            return out

    torch.manual_seed(0)
    att = SelfAttention(1024, 16, gated=True).cuda().eval()
    with torch.no_grad():
        att.gru_rel_pos_const.uniform_(0.5, 2.0)
    h = torch.randn(b, t, 1024, device="cuda")
    row = torch.randn(16, 2 * t - 1, device="cuda")
    largest = Largest()
    with torch.inference_mode():
        assert att.fused(h, torch.bfloat16)
        before = _count()
        with largest:
            got = att(h, torch.bfloat16, row=row)
        torch.cuda.synchronize()
        assert _count() == before + 1
        want = att(h, torch.bfloat16, bias=k6.bias_from_row(row, t))
    allowed, score_bytes = max(b * t * 1024, 1024 * 1024) * 2, b * 16 * t * t * 2
    gap = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    print({"layer_gap": gap, "largest_bytes": largest.nbytes,
           "score_matrix_bytes": score_bytes})
    assert gap <= TOL_BF16
    assert allowed < score_bytes
    assert largest.nbytes <= allowed


@pytest.mark.cuda
def test_encoder_counts_k6_at_eval_only():
    """An encoder with two layers of K6's head dim: 2 counts a bf16 eval
    forward, none in training, in float32 or with grad on, and the eval
    forward within the bf16 tolerance of the composition."""
    _card()
    enc = _encoder(torch.bfloat16).cuda()
    x = 0.1 * torch.randn(2, 16000, generator=torch.Generator().manual_seed(6)).cuda()
    before = _count()
    with torch.inference_mode():
        got = enc(x)
    assert _count() == before + ARCH.num_layers
    with torch.no_grad():
        enc.train()
        enc(x)
        enc.eval()
    with torch.enable_grad():
        want = enc(x)
    f32 = _encoder(torch.float32).cuda()
    with torch.inference_mode():
        f32(x)
    assert _count() == before + ARCH.num_layers
    gap = float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1))
    assert gap <= TOL_BF16, gap
