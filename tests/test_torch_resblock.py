"""K1 (folded eval SE-ResBlock body) in the port vs adfmsl.

The port's plain version (adfmsl_torch.ops.resblock_fused.resblock_eval_plain)
is held against adfmsl's Pallas kernel in interpret mode and its f32 XLA
reference, on test_pallas.py's cases plus RawNet's LeakyReLU / MaxPool3 shapes
(128->128, 128->256 with the 1x1 skip, 256->256), at test_pallas.py's
tolerance (rtol 2e-2, atol 2e-2 * max). The kernel's weight layout
(``kernel_weight_layout``) is read back on the CPU by the address arithmetic
the kernel's source note gives. The CUDA kernel is held against the plain
version on the card (marker ``cuda``), on these cases and on cases that land on
its 126-row tile's seams, for each of its three (Cin, Cout) instantiations, and
on the 62-row tile's seams of its two wide stack-head instantiations (maze2's
768 -> 128 and maze6's 1024 -> 128 with the 1x1 skip, no ``pre``), which the
plain version covers against adfmsl at small T.

JAX is imported inside the tests that compare with adfmsl, so that the card
tests also run on a machine without JAX:
    python -m pytest --noconftest -q tests/test_torch_resblock.py -m cuda
"""
import numpy as np
import pytest
import torch

from adfmsl_torch.ops import resblock_fused as rf

CASES = [  # (B, T, Cin, Cout), first, skip, act, pool
    ((2, 100, 128, 128), True, False, "relu", 1),     # stack head, identity skip
    ((2, 300, 128, 128), False, False, "relu", 1),    # ragged T vs the row tile
    ((1, 77, 128, 256), False, True, "relu", 1),      # channel change -> 1x1 skip
    ((2, 151, 128, 128), False, False, "leaky", 3),   # RawNet block, T % 3 != 0
    ((2, 130, 128, 256), False, True, "leaky", 3),    # RawNet block2: 1x1 skip
    ((2, 151, 256, 256), False, False, "leaky", 3),   # RawNet blocks 3-5, ragged T
    ((2, 23, 768, 128), True, True, "relu", 1),       # maze2's stack head
    ((1, 17, 1024, 128), True, True, "relu", 1),      # maze6's stack head
]
IDS = ["head", "ragged", "skip1x1", "leaky_pool3", "rawnet_skip1x1_pool3",
       "rawnet_256_pool3", "head768_skip1x1", "head1024_skip1x1"]
# The kernel's tile holds R = 126 output rows (42 MaxPool3 windows).
SEAM_CASES = [
    ((1, 125, 128, 128), False, False, "relu", 1),    # one row short of a tile
    ((1, 126, 128, 128), False, False, "relu", 1),    # exactly one tile
    ((1, 127, 128, 128), True, False, "relu", 1),     # one row into the second
    ((2, 252, 128, 128), False, False, "relu", 1),    # exactly two tiles
    ((1, 253, 128, 128), False, False, "relu", 1),    # one row into the third
    ((2, 379, 128, 128), False, False, "relu", 1),    # one row into the fourth
    ((1, 253, 128, 128), False, False, "leaky", 3),   # last window ends 1 row before T
    ((1, 254, 128, 128), False, False, "leaky", 3),   # last window ends 2 rows before T
    ((2, 3, 128, 128), False, False, "leaky", 3),     # one pool window
    ((2, 1, 128, 128), False, False, "relu", 1),      # one row
    ((3, 1000, 128, 128), False, False, "relu", 1),   # batch 3, eight tiles
    ((2, 379, 128, 256), False, True, "relu", 1),     # 1x1 skip instantiation
    ((1, 254, 128, 256), False, True, "leaky", 3),
    ((2, 379, 256, 256), False, False, "leaky", 3),   # 256 -> 256 instantiation
    ((1, 127, 256, 256), False, False, "relu", 1),
    # the wide stack heads' tile holds R = 62 output rows
    ((1, 61, 768, 128), True, True, "relu", 1),       # one row short of a tile
    ((2, 62, 768, 128), True, True, "relu", 1),       # exactly one tile
    ((1, 63, 1024, 128), True, True, "relu", 1),      # one row into the second
    ((2, 125, 1024, 128), True, True, "relu", 1),     # one row into the third
    ((3, 201, 1024, 128), True, True, "relu", 1),     # maze6's T 201, four tiles
    ((2, 1, 768, 128), True, True, "relu", 1),        # one row
]
SEAM_IDS = ["t125", "t126", "t127_head", "t252", "t253", "t379", "pool3_t253",
            "pool3_t254", "pool3_t3", "t1", "b3_t1000", "skip_t379", "skip_pool3_t254",
            "c256_pool3_t379", "c256_t127", "c768_t61", "c768_t62", "c1024_t63",
            "c1024_t125", "c1024_b3_t201", "c768_t1"]


def _rand_block(rng, cin, cout, first, skip):
    pre = None if first else (rng.standard_normal((2, cin)).astype(np.float32) * 0.1
                              + np.array([[1.0], [0.0]], np.float32))
    w1 = rng.standard_normal((3, cin, cout)).astype(np.float32) * .05
    b1 = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((3, cout, cout)).astype(np.float32) * .05
    bt = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    skw = rng.standard_normal((cin, cout)).astype(np.float32) * .1 if skip else None
    return pre, w1, b1, w2, bt, skw


def _torch(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, ref, scale_from):
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-2 * float(np.abs(scale_from).max()))


@pytest.mark.parametrize("shape,first,skip,act,pool", CASES, ids=IDS)
def test_plain_matches_pallas_and_reference(shape, first, skip, act, pool):
    jnp = pytest.importorskip("jax.numpy")
    from adfmsl.ops.pallas.resblock_fused import (resblock_eval_fused,
                                                  resblock_eval_reference)

    rng = np.random.default_rng(7)
    b, t, cin, cout = shape
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    args = _rand_block(rng, cin, cout, first, skip)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    yp, sp = resblock_eval_fused(jnp.asarray(x), *jargs, rows=48, act=act, pool=pool,
                                 interpret=True)
    yr, sr = resblock_eval_reference(jnp.asarray(x), *jargs, act=act, pool=pool)
    y, s = rf.resblock_eval_plain(torch.from_numpy(x), *map(_torch, args),
                                  act=act, pool=pool)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert tuple(y.shape) == (b, t // pool, cout) and tuple(s.shape) == (b, cout)
    y, s = y.float().numpy(), s.numpy()
    yp, sp = np.asarray(yp, np.float32), np.asarray(sp)
    yr, sr = np.asarray(yr), np.asarray(sr)
    _close(y, yp, yr)
    _close(s, sp, sr)
    _close(y, yr, yr)
    _close(s, sr, sr)


@pytest.mark.parametrize("first,skip", [(True, False), (False, False), (False, True)],
                         ids=["head", "identity", "skip1x1"])
def test_fold_block_params_matches_adfmsl(first, skip):
    pytest.importorskip("jax")
    from adfmsl.ops.pallas.resblock_fused import fold_block_params as jax_fold

    rng = np.random.default_rng(3)
    cin, cout = 128, 256 if skip else 128

    def bn(c):
        p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.standard_normal(c).astype(np.float32) * 0.1}
        s = {"mean": rng.standard_normal(c).astype(np.float32) * 0.3,
             "var": rng.uniform(0.1, 1.0, c).astype(np.float32)}
        return p, s

    def conv(k, ci, co):
        return {"kernel": rng.standard_normal((k, ci, co)).astype(np.float32) * .05,
                "bias": rng.standard_normal(co).astype(np.float32) * 0.1}

    params, stats = {}, {}
    if not first:
        params["bn1"], stats["bn1"] = bn(cin)
    params["conv1"] = conv(3, cin, cout)
    params["bn2"], stats["bn2"] = bn(cout)
    params["conv2"] = conv(3, cout, cout)
    if skip:
        params["downsample"] = conv(1, cin, cout)
    ref = jax_fold(params, stats, first=first)

    t = {}
    for name, p in params.items():
        if "kernel" in p:
            t[f"{name}.weight"] = torch.from_numpy(p["kernel"].transpose(2, 1, 0).copy())
            t[f"{name}.bias"] = torch.from_numpy(p["bias"])
        else:
            t[f"{name}.weight"] = torch.from_numpy(p["scale"])
            t[f"{name}.bias"] = torch.from_numpy(p["bias"])
            t[f"{name}.running_mean"] = torch.from_numpy(stats[name]["mean"])
            t[f"{name}.running_var"] = torch.from_numpy(stats[name]["var"])
    got = rf.fold_block_params(t, first=first)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 40, 128)).astype(np.float32))
    args = [_torch(a) for a in _rand_block(rng, 128, 128, False, False)]
    before = rf.resblock_eval.launches
    y, s = rf.resblock_eval(x.bfloat16(), *args)
    yp, sp = rf.resblock_eval_plain(x.bfloat16(), *args)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert rf.resblock_eval.launches == before          # no kernel ran
    with pytest.raises(ValueError):
        rf.resblock_eval(x.to("meta"), *args)


def _read_kernel_layout(flat, taps, k, n):
    """Weight (taps, K, N) read back from the kernel's slice layout by the
    address arithmetic of csrc/resblock_eval.cu's note: slice (tap, k // 64),
    then element (n, k % 64) at ((n//8)*8 + (k%64)//8)*64 + (n%8)*8 + k%8."""
    d, kk, nn = np.meshgrid(np.arange(taps), np.arange(k), np.arange(n), indexing="ij")
    kl = kk % 64
    off = ((d * (k // 64) + kk // 64) * n * 64
           + ((nn // 8) * 8 + kl // 8) * 64 + (nn % 8) * 8 + kl % 8)
    return flat[torch.from_numpy(off.reshape(-1))].reshape(taps, k, n)


@pytest.mark.parametrize("cin,cout,skip", rf.KERNEL_SHAPES,
                         ids=["c128_128", "c128_256_skip", "c256_256", "c768_128_skip",
                              "c1024_128_skip"])
def test_kernel_weight_layout_reads_back_bit_for_bit(cin, cout, skip):
    rng = np.random.default_rng(13)
    _, w1, _, w2, _, skw = _rand_block(rng, cin, cout, False, skip)
    for w in (w1, w2) + ((skw,) if skip else ()):
        w = torch.from_numpy(w)
        flat = rf.kernel_weight_layout(w)
        assert flat.dtype == torch.bfloat16 and flat.dim() == 1 and flat.is_contiguous()
        assert flat.numel() == w.numel()
        ref = w.to(torch.bfloat16).reshape((-1,) + tuple(w.shape[-2:]))
        got = _read_kernel_layout(flat, *ref.shape)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_launch_refuses_shapes_the_kernel_lacks():
    rng = np.random.default_rng(17)
    for cin, cout, skip in ((64, 64, False), (128, 128, True), (256, 128, True)):
        x = torch.zeros((1, 10, cin), dtype=torch.bfloat16)
        args = [_torch(a) for a in _rand_block(rng, cin, cout, False, skip)]
        with pytest.raises(ValueError, match="the kernel takes"):
            rf._launch(x, *args, act="relu", pool=1)
    # the wide heads: at the stack head only (no pre, no pool)
    for cin, first, pool in ((768, False, 1), (1024, False, 1), (1024, True, 3)):
        x = torch.zeros((1, 12, cin), dtype=torch.bfloat16)
        args = [_torch(a) for a in _rand_block(rng, cin, 128, first, True)]
        with pytest.raises(ValueError, match="stack head only"):
            rf._launch(x, *args, act="relu", pool=pool)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,first,skip,act,pool", CASES + SEAM_CASES,
                         ids=IDS + SEAM_IDS)
def test_kernel_matches_plain_on_card(shape, first, skip, act, pool, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU form")
    rng = np.random.default_rng(11)
    b, t, cin, cout = shape
    x = torch.from_numpy(rng.standard_normal((b, t, cin)).astype(np.float32))
    x = x.cuda().bfloat16()
    args = [None if a is None else _torch(a).cuda()
            for a in _rand_block(rng, cin, cout, first, skip)]
    # the plain version in exact f32: no TF32 in cuDNN convs or cuBLAS matmuls
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    yp, sp = rf.resblock_eval_plain(x, *args, act=act, pool=pool)
    before = rf.resblock_eval.launches
    y, s = rf.resblock_eval(x, *args, act=act, pool=pool)
    torch.cuda.synchronize()
    assert rf.resblock_eval.launches == before + 1
    yp, sp = yp.float().cpu().numpy(), sp.cpu().numpy()
    np.testing.assert_allclose(y.float().cpu().numpy(), yp, rtol=0,
                               atol=2e-2 * float(np.abs(yp).max()))
    np.testing.assert_allclose(s.cpu().numpy(), sp, rtol=0,
                               atol=1e-3 * float(np.abs(sp).max()))

