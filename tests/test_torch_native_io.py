"""The port's native audio IO (``adfmsl_torch/io_native.py``, built from
``adfmsl_torch/csrc/audio_decode.cc`` with g++ at first use) against adfmsl's
(``adfmsl.io_native``, its prebuilt ``libadfmsl_io.so``).

Every decode is held BITWISE equal to adfmsl's: samples, rates and lengths.
FLAC vectors come from the port's writer (``adfmsl_torch/data/flac.py``, a
numpy copy of the writer at tests/test_native_io.py:40 that adds FIXED
subframes of predictor orders 0-4 with Rice residuals), so each decoded
stream must also equal the int16 PCM written. Then ``load_audio`` of a
22,050 Hz FLAC, the native ``DataLoader`` batches at 1 and 3 workers, the
failed build, and ``cli.evaluate`` over a FLAC fixture against its WAV twin.
"""
import os
import struct

import numpy as np
import pytest

import adfmsl.io_native as ref_io
from adfmsl.data.audio import load_audio as ref_load_audio
from adfmsl.data.pipeline import AsvspoofDataset as RefDataset
from adfmsl.data.pipeline import DataLoader as RefLoader
from adfmsl.data.protocol import parse_protocol as ref_parse_protocol
from adfmsl_torch import io_native
from adfmsl_torch.data import (AsvspoofDataset, DataLoader, SyntheticSpec, generate_fixture,
                               load_audio, parse_protocol, write_wav)
from adfmsl_torch.data.flac import flac_twin, write_flac
from adfmsl_torch.ops import _build

pytestmark = pytest.mark.skipif(not ref_io.native_available(),
                                reason="adfmsl's native IO library is not built")

CUT = 4000


def _pcm(seed, n=20000, amp=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = amp * np.sin(2 * np.pi * 330 * t) + rng.integers(-200, 200, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _same(a, b):
    """Both decoders' (samples, rate) bitwise equal."""
    (xa, sa), (xb, sb) = a, b
    assert sa == sb and xa.shape == xb.shape and xa.dtype == xb.dtype == np.float32
    assert np.array_equal(xa, xb)


FLAC_CASES = {
    "verbatim": dict(subframe="verbatim"),
    "constant_tail": dict(subframe="verbatim", constant_tail=True),
    **{f"fixed_order{k}": dict(subframe="fixed", orders=(k,)) for k in range(5)},
    "fixed_orders_0_4_cycled": dict(subframe="fixed", block_size=1024),
    "fixed_22050hz": dict(subframe="fixed", sr=22050),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_decode_flac_bitwise_equal_to_adfmsl(case, tmp_path):
    kw = dict(FLAC_CASES[case])
    pcm = _pcm(len(case))
    if kw.get("constant_tail"):
        pcm = np.concatenate([pcm[:4096], np.full(1000, 123, np.int16)])
    p = str(tmp_path / f"{case}.flac")
    write_flac(p, pcm, **kw)
    got = io_native.decode_flac(p)
    _same(got, ref_io.decode_flac(p))
    assert got[1] == kw.get("sr", 16000)
    assert np.array_equal(np.round(got[0] * 32768.0).astype(np.int16), pcm)
    assert np.array_equal(got[0] * 32768.0, pcm.astype(np.float32))   # exact


def _wav_float(path, x, bits):
    """IEEE-float WAV (format 3), 32 or 64 bits a sample."""
    raw = x.astype(np.float32 if bits == 32 else np.float64).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 16000 * bits // 8,
                                 bits // 8, bits)
    with open(path, "wb") as fh:
        fh.write(hdr + b"data" + struct.pack("<I", len(raw)) + raw)


@pytest.mark.parametrize("fmt", ["pcm16", "float32", "float64"])
def test_decode_wav_bitwise_equal_to_adfmsl(fmt, tmp_path):
    x = (0.3 * np.sin(np.arange(7001) * 0.05)).astype(np.float32)
    p = str(tmp_path / f"{fmt}.wav")
    if fmt == "pcm16":
        write_wav(p, x, 16000)
    else:
        _wav_float(p, x, 32 if fmt == "float32" else 64)
    got = io_native.decode_wav_native(p)
    _same(got, ref_io.decode_wav_native(p))
    assert got[1] == 16000 and len(got[0]) == 7001
    if fmt != "pcm16":
        assert np.array_equal(got[0], x)


def test_unsupported_wav_format_raises_cleanly(tmp_path):
    """8-bit PCM: both decoders refuse it with the same error code."""
    raw = np.full(100, 128, np.uint8).tobytes()
    p = str(tmp_path / "u8.wav")
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000, 1, 8)
    with open(p, "wb") as fh:
        fh.write(hdr + b"data" + struct.pack("<I", len(raw)) + raw)
    for decode in (io_native.decode_wav_native, ref_io.decode_wav_native):
        with pytest.raises(ValueError, match=r"err -3"):
            decode(p)
    # load_audio takes it through numpy, as adfmsl's does
    np.testing.assert_array_equal(load_audio(p)[0], ref_load_audio(p)[0])


@pytest.fixture(scope="module")
def batch_files(tmp_path_factory):
    """FLAC and WAV files shorter and longer than CUT, one corrupt file and a
    missing path."""
    d = tmp_path_factory.mktemp("batch")
    paths = []
    for i, n in enumerate((1500, 4000, 9000, 333)):
        p = str(d / f"f{i}.flac")
        write_flac(p, _pcm(10 + i, n), block_size=512)
        paths.append(p)
    for i, n in enumerate((2500, 6000)):
        p = str(d / f"w{i}.wav")
        write_wav(p, 0.2 * np.cos(np.arange(n) * 0.01 * (i + 1)), 16000)
        paths.append(p)
    bad = str(d / "bad.flac")
    with open(bad, "wb") as fh:
        fh.write(b"fLaC\x00\x00\x00\x02xx")
    return paths + [bad, str(d / "missing.flac")]


@pytest.mark.parametrize("pad_mode", ["tile", "zero"])
def test_batch_decode_pad_bitwise_equal_to_adfmsl(pad_mode, batch_files):
    outs = {}
    for threads in (1, 4):
        got = io_native.batch_decode_pad(batch_files, CUT, pad_mode, n_threads=threads)
        ref = ref_io.batch_decode_pad(batch_files, CUT, pad_mode, n_threads=threads)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        outs[threads] = got
    for a, b in zip(outs[1], outs[4]):
        assert np.array_equal(a, b)
    audio, srs, lens = outs[1]
    assert audio.shape == (len(batch_files), CUT)
    assert list(lens) == [1500, 4000, 4000, 333, 2500, 4000, 0, 0]
    assert list(srs) == [16000] * 6 + [0, 0]
    assert not audio[-2:].any()                        # corrupt and missing: zeros
    row = audio[0]
    if pad_mode == "tile":
        np.testing.assert_array_equal(row[1500:3000], row[:1500])
    else:
        assert not row[1500:].any()


def test_load_audio_of_22050hz_flac_equals_adfmsl(tmp_path):
    p = str(tmp_path / "a.flac")
    write_flac(p, _pcm(3, 22050), sr=22050)
    for native in (True, False):
        x, sr = load_audio(p, 16000, prefer_native=native)
        y, sr_ref = ref_load_audio(p, 16000, prefer_native=native)
        assert sr == sr_ref == 16000 and len(x) == 16000
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def flac_fixture(tmp_path_factory):
    """A synthetic fixture, its eval split written again as FLAC (one file at
    22,050 Hz, so the loader's resampling branch runs, and one missing)."""
    root = tmp_path_factory.mktemp("flac_fixture")
    info = generate_fixture(str(root / "wav"), SyntheticSpec(n_train=4, n_dev=4, n_eval=10))
    ev = info["eval"]
    flac_dir = str(root / "flac")
    assert flac_twin(ev["audio_dir"], flac_dir) == 10
    u0, u1 = ev["utt_ids"][:2]
    write_flac(os.path.join(flac_dir, u0 + ".flac"), _pcm(7, 30000), sr=22050)
    os.remove(os.path.join(flac_dir, u1 + ".flac"))
    return info, flac_dir


@pytest.mark.parametrize("workers", [1, 3])
def test_native_loader_batches_equal_adfmsl(workers, flac_fixture):
    info, flac_dir = flac_fixture
    ev = info["eval"]
    ours = DataLoader(AsvspoofDataset(parse_protocol(ev["protocol"]), flac_dir, cut=CUT,
                                      num_workers=workers), 4, prefetch=0)
    theirs = RefLoader(RefDataset(ref_parse_protocol(ev["protocol"]), flac_dir, cut=CUT,
                                  num_workers=workers), 4, prefetch=0)
    n = 0
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.audio, b.audio) and np.array_equal(a.label, b.label)
        assert np.array_equal(a.mask, b.mask) and a.utt_ids == b.utt_ids
        n += 1
    assert n == 3
    first = next(iter(ours)).audio
    assert first[0].any() and not first[1].any()       # resampled row; missing row


@pytest.mark.parametrize("cxx,message", [("/nonexistent/g++", "cannot run"),
                                         ("false", "false failed for adfmsl_torch_io")])
def test_failed_build_raises_with_the_compiler_log(cxx, message, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", cxx)
    io_native._lib.cache_clear()
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=message):
            io_native.native_available()
    finally:
        io_native._lib.cache_clear()
        _build.load_library.cache_clear()


def test_cli_evaluate_flac_fixture_equals_wav_twin(tmp_path, capsys):
    """maze5 at a small cut on the CPU: the score file over the FLAC eval split
    is byte for byte the one over its WAV twin."""
    from adfmsl_torch.cli import evaluate

    info = generate_fixture(str(tmp_path / "wav"), SyntheticSpec(n_train=2, n_dev=2, n_eval=6))
    ev = info["eval"]
    flac_dir = str(tmp_path / "flac")
    flac_twin(ev["audio_dir"], flac_dir)
    texts = []
    for d in (ev["audio_dir"], flac_dir):
        out = tmp_path / f"scores_{len(texts)}.txt"
        rc = evaluate.main(["--model_type", "maze5", "--protocol", ev["protocol"],
                            "--data_dir", d, "--output", str(out), "--batch_size", "4",
                            "--cut", str(CUT), "--device", "cpu", "--seed", "1"])
        assert rc == 0
        texts.append(out.read_bytes())
    assert texts[0] == texts[1]
    assert [ln.split()[0] for ln in texts[0].decode().splitlines()] == ev["utt_ids"]
    assert not any(f.endswith(".wav") for f in os.listdir(flac_dir))
