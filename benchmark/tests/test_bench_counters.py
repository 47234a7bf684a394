"""The yardstick's arithmetic against hand counts."""
import numpy as np
import pytest

from benchlib import common, roofline, train_driver
from reference import sinc_maze, w2v2_maze


def test_maze5_fmsl_forward_flops_by_hand():
    cfg = common.load_json("configs", "maze5_fmsl.json")
    t = 64600 - 251 + 1                                        # 64,350 frames
    sinc = 2 * t * 128 * 251
    blocks = [(64350, 128, 128), (32175, 128, 128), (16088, 128, 128), (8044, 128, 128),
              (4022, 128, 256)]
    trunk = sum(2 * tb * 3 * (ci * co + co * co) + (2 * tb * ci * co if ci != co else 0)
                for tb, ci, co in blocks)
    head = 2 * (256 * 1024 + 1024 * 1024 + 1024 * 2)
    assert sinc_maze.forward_flops(cfg, 64600) == sinc + trunk + head
    assert sinc_maze.train_flops(cfg, 64600) == 3 * (sinc + trunk + head) - sinc
    assert sinc_maze.k1_calls(cfg, 64600) == [(64350, 128, 128, False, False),
                                             (32175, 128, 128, True, False),
                                             (16088, 128, 128, True, False),
                                             (8044, 128, 128, True, False),
                                             (4022, 128, 256, True, True)]


def test_maze6_forward_flops_by_hand():
    cfg = common.load_json("configs", "maze6.json")
    ts = [12919, 6459, 3229, 1614, 806, 403, 201]
    ks = [10, 3, 3, 3, 3, 2, 2]
    ext = 2 * ts[0] * 10 * 512 + sum(2 * t * k * 512 * 512 for t, k in zip(ts[1:], ks[1:]))
    t = 201
    enc = 2 * t * 512 * 1024 + 2 * t * 1024 * 64 * 128
    layer = 4 * 2 * t * 1024 * 1024 + 2 * 2 * t * t * 1024 + 2 * 2 * t * 1024 * 4096
    fuse = 2 * t * 5120 * 1024
    tb = [(201, 1024, 128), (101, 128, 128), (51, 128, 128), (26, 128, 128), (13, 128, 256)]
    trunk = sum(2 * n * 3 * (ci * co + co * co) + (2 * n * ci * co if ci != co else 0)
                for n, ci, co in tb)
    small = 4 * (4 * 2 * 13 * 256 * 256 + 2 * 2 * 13 * 13 * 256 + 2 * 2 * 13 * 256 * 2048)
    tail = 2 * 13 * 256 * 128 + 2 * 13 * 128 + 2 * 512 * 1024 + 2 * 1024 * 2
    want = ext + enc + 24 * layer + fuse + trunk + small + tail
    assert w2v2_maze.frames(cfg["w2v2"], 64600) == ts
    assert w2v2_maze.forward_flops(cfg, 64600) == pytest.approx(want, rel=1e-12)
    assert [c[0] for c in w2v2_maze.k1_calls(cfg, 64600)] == [201, 101, 51, 26, 13]


def test_k1_bound_by_hand():
    """maze5's block4 at batch 128: the products bound it."""
    b, t, ci, co = 128, 4022, 128, 256
    flops = 2 * b * t * (3 * ci * co + 3 * co * co + ci * co)
    nbytes = (2 * b * t * ci + 2 * b * t * co + 4 * b * co + 2 * (3 * ci * co + 3 * co * co + ci * co)
              + 4 * 2 * co + 4 * 2 * ci)
    want = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    assert roofline.k1_bound_ms(b, t, ci, co, True, True) == pytest.approx(want, rel=1e-12)


def test_rate_and_percentile_take_every_sample():
    """A slow tail in one stretch of the window moves the p90 and the rate,
    where a median of chunks would hide it."""
    steps = [0.2] * 90 + [1.0] * 20 + [0.2] * 30
    m = train_driver.window_metrics(steps, rows=32 * len(steps), window_s=sum(steps))
    assert m["train_step_ms_p90"]["value"] == pytest.approx(1e3 * np.percentile(steps, 90))
    assert m["train_step_ms_p90"]["value"] == pytest.approx(1000.0)
    assert m["train_utt_per_s"]["value"] == pytest.approx(32 * 140 / 44.0)
