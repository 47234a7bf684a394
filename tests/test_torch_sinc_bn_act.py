"""K5 (the maze4 / maze5 eval front end: the TF32 sinc conv, first_bn and SELU
in one kernel, ``adfmsl_torch.ops.sinc_bn_act``) against the composition it
stands in for.

On the CPU: the plain version equals the composition bit for bit, the filter
layout, the wrapper's checks, the model's dispatch (eval, grad off, bf16, a
card, cuDNN's TF32 on, widths K5 takes), and a maze5_fmsl forward through the
K5 path (the plain version on the CPU) scoring bit for bit as the composition
does.

On a card (marker ``cuda``; no JAX here, so the file runs on a machine
without it): the kernel bit for bit on operands of at most 6 significant bits
and on operands of 9 and 10, which TF32 holds and bf16 does not (every TF32
product and f32 partial sum exact, in any order), within
``composition_gap``'s derived bound on random audio with at least a floor of
the outputs equal bit for bit, a maze5_fmsl eval forward within the benchmark
cell's score limit, the counter, an eval forward with grad enabled keeping the
composition and its gradients, and the host syncs of an eval batch:
    python -m pytest --noconftest -q tests/test_torch_sinc_bn_act.py -m cuda
"""
import types
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adfmsl_torch.config import make_experiment
from adfmsl_torch.models import build_model
from adfmsl_torch.models.mazes import MazeModel
from adfmsl_torch.ops import sinc_bn_act as k5
from adfmsl_torch.ops.norm import batch_norm, bn_eval, eval_affine
from adfmsl_torch.ops.sinc import sinc_conv_nhc, sinc_filters, sinc_init
from adfmsl_torch.ops.sinc_fused import tf32_round
from adfmsl_torch.utils import profiling

COUNTER = "sinc.fused_bn_act"
SCORE_GAP = 0.18            # benchmark/workloads/maze5_fmsl.eval.b128.json's limit


def _filters(c=128, k=251):
    low, band = sinc_init(c)
    return sinc_filters(torch.from_numpy(low), torch.from_numpy(band), k)


def _bn(c, seed=0):
    """A first_bn with statistics far from the identity, so the affine shows."""
    g = torch.Generator().manual_seed(seed)
    bn = batch_norm(c)
    with torch.no_grad():
        bn.running_mean.copy_(0.01 * torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 1e-3 + 1e-4)
        bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.3 * torch.randn(c, generator=g))
    return bn


def _composition(x, f, bn):
    """``MazeModel._frontend``'s eval composition after the sinc conv."""
    return F.selu(bn_eval(sinc_conv_nhc(x, f).to(torch.bfloat16), bn, torch.bfloat16))


def _count():
    return profiling.totals().get(COUNTER, 0)


@pytest.mark.parametrize("b,t,c,k", [(2, 4000, 128, 251), (1, 1000, 64, 129),
                                     (3, 700, 256, 251)],
                         ids=["maze5", "c64_k129", "c256"])
def test_plain_equals_the_composition(b, t, c, k):
    f, bn = _filters(c, k), _bn(c)
    x = 0.1 * torch.randn(b, t, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = k5.sinc_bn_act_plain(x, f, *eval_affine(bn))
        want = _composition(x, f, bn)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == (b, t - k + 1, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,k", [(64, 251), (256, 129)])
def test_kernel_filters_pad_and_lay_out(c, k):
    """128-channel tiles and 32-tap groups, zero-padded, in the TF32 core-matrix
    form: element (n, k) at ((n // 8) * (KP // 4) + k // 4) * 32 + (n % 8) * 4 + k % 4."""
    f = torch.randn(c, k, generator=torch.Generator().manual_seed(2))
    w = k5.kernel_filters(f)
    cp, kp = -(-c // 128) * 128, -(-k // 32) * 32
    assert w.dtype == torch.float32 and tuple(w.shape) == (cp * kp,)
    n, j = np.meshgrid(np.arange(cp), np.arange(kp), indexing="ij")
    at = torch.from_numpy(((n // 8) * (kp // 4) + j // 4) * 32 + (n % 8) * 4 + j % 4)
    dense = w[at]
    assert torch.equal(dense[:c, :k], tf32_round(f))
    assert not dense[c:].any() and not dense[:, k:].any()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_selu_table_is_torchs_selu_of_every_negative_bf16(device):
    """The kernel's SELU for y < 0: entry i is F.selu of the negative bf16 of
    magnitude bits i, and every negative bf16 from -8 to -inf (the entries the
    kernel clamps to the last) has the last entry's SELU."""
    if device == "cuda":
        _card()
    table = k5.selu_table(torch.device(device))
    last = k5.SELU_TABLE_LAST
    assert table.dtype == torch.int16 and tuple(table.shape) == (k5.SELU_TABLE_SIZE,)
    mags = torch.arange(0x7F81, dtype=torch.int32, device=device)
    y = (mags - 0x8000).to(torch.int16).view(torch.bfloat16)
    assert float(y[-1]) == float("-inf")
    want = F.selu(y).view(torch.int16)
    assert torch.equal(table[:last + 1], want[:last + 1])
    assert bool((want[last:] == table[last]).all())
    assert not table[last + 1:].any()


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    f, bn = _filters(), _bn(128)
    x = 0.1 * torch.randn(2, 1000, generator=torch.Generator().manual_seed(3))
    before = _count()
    with torch.inference_mode():
        got = k5.sinc_bn_act_fused(x, f, *eval_affine(bn))
        assert torch.equal(got, k5.sinc_bn_act_plain(x, f, *eval_affine(bn)))
        assert _count() == before                                  # no kernel ran
        with pytest.raises(ValueError):
            k5.sinc_bn_act_fused(x.to("meta"), f, *eval_affine(bn))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked in the wrapper, before the library is built or loaded."""
    f = _filters()
    x = torch.zeros(2, 1000)
    bn = [torch.zeros(128), torch.ones(128), torch.zeros(128)]
    bad = [((x.double(), f), bn), ((x[:, ::2], f), bn), ((x, f[:120]), bn),
           ((x, torch.zeros(272, 251)), bn), ((x, torch.zeros(128, 257)), bn),
           ((x[:, :250], f), bn), ((x, f.double()), bn),
           ((x, f), [bn[0][:64], bn[1], bn[2]]), ((x, f), [bn[0], bn[1].double(), bn[2]]),
           ((x, f), [bn[0], bn[1], torch.zeros(256)[::2]])]
    for (bx, bf), bbn in bad:
        with pytest.raises(ValueError):
            k5._launch(bx, bf, *bbn)


def _model(name="maze5_fmsl", **arch):
    exp = make_experiment(name)
    for key, v in arch.items():
        if key == "dtype":
            exp.model.dtype = v
        else:
            setattr(exp.model.architecture, key, v)
    return build_model(exp.model, device="cpu", seed=0)


CARD = types.SimpleNamespace(is_cuda=True)      # the one property of x the rule reads
HOST = types.SimpleNamespace(is_cuda=False)


@pytest.mark.parametrize("case", ["eval_bf16_card", "train", "float32", "cpu", "no_tf32",
                                  "c_over_limit", "c_not_16", "k_over_limit", "k_even_256",
                                  "grad_enabled"])
def test_dispatch(case, monkeypatch):
    """``MazeModel._k5_operands``: first_bn's (mean, mul, bias) at eval with
    grad off in a bf16 model on a card with cuDNN's TF32 on and widths K5
    takes; None otherwise (the composition runs, and with grad enabled keeps
    the gradients to the sinc band edges and first_bn)."""
    arch = {"c_over_limit": {"filts": [272, [272, 128], [128, 256]]},
            "c_not_16": {"filts": [120, [120, 128], [128, 256]]},
            "k_over_limit": {"first_conv": 257},
            "k_even_256": {"first_conv": 256},          # sinc_filters makes it 257
            "float32": {"dtype": "float32"}}.get(case, {})
    model = _model(**arch)
    x = HOST if case == "cpu" else CARD
    if case == "train":
        model.train()
    if case == "no_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with torch.set_grad_enabled(case == "grad_enabled"):
        got = model._k5_operands(x)
    if case != "eval_bf16_card":
        assert got is None
        return
    want = eval_affine(model.first_bn)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))


def _force_k5(monkeypatch, calls):
    """Take K5's path wherever the model is at eval, whatever the device (the
    plain version then runs on the CPU), and count the front end's calls."""
    import adfmsl_torch.models.sincnet as sincnet

    def operands(self, x):
        return None if self.training else eval_affine(self.first_bn)

    def fused(*a):
        calls.append(1)
        return k5.sinc_bn_act_fused(*a)

    monkeypatch.setattr(MazeModel, "_k5_operands", operands)
    monkeypatch.setattr(sincnet, "sinc_bn_act_fused", fused)


def test_maze5_fmsl_forward_through_k5_path_scores_as_the_composition(monkeypatch):
    """On the CPU the K5 path (the plain version) gives the composition's
    logits, scores and features bit for bit: the model skips its own first_bn
    and SELU exactly where K5 takes them."""
    model = _model()
    with torch.no_grad():
        model.first_bn.load_state_dict(_bn(128).state_dict())
    x = 0.1 * torch.randn(2, 4000, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = model(x)
        calls = []
        _force_k5(monkeypatch, calls)
        got = model(x)
    assert calls == [1]
    for key in ("logits", "scores", "features"):
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------- on a card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K5 kernel has no CPU form")


def _bn_operands(c, seed, dev, scale):
    """mean, mul and bias that put y on both sides of SELU's knee."""
    g = torch.Generator().manual_seed(seed)
    mean = scale * 0.1 * torch.randn(c, generator=g)
    mul = (1 + torch.rand(c, generator=g)) / scale
    bias = 0.5 * torch.randn(c, generator=g)
    return [t.to(dev) for t in (mean, mul, bias)]


SHAPES = [(128, 64600, 128, 251), (1, 64600, 128, 251), (3, 8001, 128, 251),
          (2, 16000, 64, 251), (2, 16000, 256, 251), (2, 16000, 128, 129)]
SHAPE_IDS = ["cell_b128", "b1", "t_ragged", "c64", "c256", "k129"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", SHAPES + [(4, 300, 128, 251)],
                         ids=SHAPE_IDS + ["one_short_tile"])
def test_kernel_bit_exact_on_exact_operands(b, t, c, k):
    """x and the filters are multiples of 1/32 below 2 (at most 6 significant
    bits): TF32 keeps them, each product is exact, and every partial sum (below
    1024, a multiple of 2^-10: 20 bits) is exact in f32, so the conv is the
    same on both sides in any order, and so is everything after it."""
    _card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(b * 7 + c + k)
    x = (torch.randint(-63, 64, (b, t), generator=g) / 32.0).to(dev)
    f = (torch.randint(-63, 64, (c, k), generator=g) / 32.0).to(dev)
    bn = _bn_operands(c, k, dev, scale=20.0)
    before = _count()
    got = k5.sinc_bn_act_fused(x, f, *bn)
    torch.cuda.synchronize()
    assert _count() == before + 1
    want = k5.sinc_bn_act_plain(x, f, *bn)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == want.shape == (b, t - k + 1, c)
    same = got.view(torch.int16) == want.view(torch.int16)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} differ"


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", SHAPES + [(4, 300, 128, 251)],
                         ids=SHAPE_IDS + ["one_short_tile"])
def test_kernel_bit_exact_on_operands_tf32_holds_and_bf16_does_not(b, t, c, k):
    """x of up to 10 significant bits (multiples of 2^-10 below 1) and filters of
    9 (multiples of 2^-10 from 1/4 to 1/2), 16 nonzero taps a channel: TF32
    keeps them and bf16 does not, each product is exact, and every partial sum
    (below 16 * 2^19 = 2^23 units of 2^-20) is exact in f32 in any order. So a
    kernel that rounded either operand to bf16 differs here."""
    _card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(b * 11 + c + k)
    x = torch.randint(-1023, 1024, (b, t), generator=g) / 1024.0
    mag = torch.randint(256, 512, (c, k), generator=g)
    sign = torch.randint(0, 2, (c, k), generator=g) * 2 - 1
    keep = torch.rand(c, k, generator=g).argsort(dim=1) < 16
    f = torch.where(keep, sign * mag, 0) / 1024.0
    for t_ in (x, f[keep]):
        assert float((t_.bfloat16().float() != t_).float().mean()) > 0.4
    x, f = x.to(dev), f.to(dev)
    bn = _bn_operands(c, k + 1, dev, scale=float(sinc_conv_nhc(x[:1], f).std()))
    got = k5.sinc_bn_act_fused(x, f, *bn)
    want = k5.sinc_bn_act_plain(x, f, *bn)
    assert got.shape == want.shape == (b, t - k + 1, c)
    same = got.view(torch.int16) == want.view(torch.int16)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} differ"


# The least share of elements K5 gives bit for bit as the composition on random
# audio (the rest differ by the order of the f32 sums, one bf16 step at most).
# The H100 reads 0.9997 at C 128 and 256; at C 64 and K 129, where cuDNN runs
# another conv kernel, 0.933 and 0.938. The composition fed operands rounded to
# bf16 reads 0.629-0.647 at these shapes (and stays within the gap's bound), so
# each floor sits between the two.
EQUAL_SHARE_FLOOR = {"cell_b128": 0.99, "b1": 0.99, "t_ragged": 0.99, "c64": 0.9,
                     "c256": 0.99, "k129": 0.9}


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", SHAPES, ids=SHAPE_IDS)
def test_kernel_within_bound_on_random_audio(b, t, c, k, request):
    """0.1 * N(0, 1) audio through the init filters: every element within
    ``composition_gap``'s bound (TF32 operand rounding and the epilogue's bf16
    roundings, carried element by element) of the composition under cuDNN's
    TF32, which the model ran before K5."""
    _card()
    dev = torch.device("cuda")
    x = 0.1 * torch.randn(b, t, generator=torch.Generator().manual_seed(b + t)).to(dev)
    f = _filters(c, k).to(dev)
    bn = _bn_operands(c, t, dev, scale=float(sinc_conv_nhc(x[:1], f).std()))
    assert torch.backends.cudnn.allow_tf32
    got = k5.sinc_bn_act_fused(x, f, *bn)
    gap = k5.composition_gap(got, x, f, *bn)
    print(gap)
    assert gap["max_gap_over_bound"] <= 1.0, gap
    assert gap["equal_share"] >= EQUAL_SHARE_FLOOR[request.node.callspec.id], gap


def _card_model(name="maze5_fmsl", fused_trunk=True):
    from adfmsl_torch.cli.evaluate import set_fused_extras
    from adfmsl_torch.models import SPECS

    exp = make_experiment(name)
    if name == "maze6":
        exp.model.wav2vec2.model_name = "tiny"
        return build_model(exp.model, device="cuda", seed=0)
    set_fused_extras(exp, SPECS[name], fused_frontend=False, fused_trunk=fused_trunk)
    model = build_model(exp.model, device="cuda", seed=0)
    with torch.no_grad():
        model.first_bn.load_state_dict(_bn(128).state_dict())
    return model


def _audio(b=8, t=16000, seed=5):
    return (0.1 * torch.randn(b, t, generator=torch.Generator().manual_seed(seed))).cuda()


@pytest.mark.cuda
def test_maze5_fmsl_eval_forward_within_the_cells_score_limit(monkeypatch):
    _card()
    model = _card_model()
    x = _audio()
    with torch.inference_mode():
        before = _count()
        got = model(x)["scores"]
        assert _count() == before + 1
        monkeypatch.setattr(MazeModel, "_k5_operands", lambda self, x: None)
        want = model(x)["scores"]
        assert _count() == before + 1
    gap = float((got.double() - want.double()).abs().max())
    print({"score_gap": gap})
    assert gap <= SCORE_GAP


@pytest.mark.cuda
def test_counter_counts_eval_forwards_only():
    """One count a maze5_fmsl eval forward; none in training, none on maze6
    (no sinc front end)."""
    _card()
    model = _card_model()
    x = _audio(b=4)
    before = _count()
    with torch.inference_mode():
        for _ in range(3):
            model(x)
    assert _count() == before + 3
    model.train()
    gens = {k: torch.Generator(device="cuda").manual_seed(i)
            for i, k in enumerate(("dropout", "specaugment", "lsa"))}
    model(x, labels=torch.tensor([0, 1, 0, 1], device="cuda"), rngs=gens)
    assert _count() == before + 3
    maze6 = _card_model("maze6")
    with torch.inference_mode():
        maze6(x)
    assert _count() == before + 3


@pytest.mark.cuda
def test_eval_forward_with_grad_keeps_the_composition_and_its_gradients():
    """An eval forward with grad enabled takes the composition (K5 has no
    backward): no count, and the gradients reach the band edges and first_bn
    (through the composition's trunk: K1 has no backward either)."""
    _card()
    model = _card_model(fused_trunk=False)
    x = _audio(b=4)
    before = _count()
    model(x)["logits"].float().sum().backward()
    assert _count() == before
    for p in (model.sinc.low_hz, model.sinc.band_hz, model.first_bn.weight,
              model.first_bn.bias):
        assert p.grad is not None and bool(p.grad.abs().sum() > 0)


@pytest.mark.cuda
def test_eval_batch_makes_the_sinc_filters_three_syncs():
    """K5 adds no host sync: an eval forward still blocks the host three
    times, all in ``sinc_filters``, by the counter and by the sync debug mode."""
    _card()
    model = _card_model()
    x = _audio(b=4)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        before = profiling.totals().get("host_syncs", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model(x)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert profiling.totals().get("host_syncs", 0) - before == 3
    assert len(warned) == 3
