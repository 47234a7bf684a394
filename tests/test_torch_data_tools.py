"""The port's data tools against adfmsl's on the same inputs: the device pads
(``data/pad.py``), ``gen_spoof_list`` (``data/protocol.py``), the fuzzy
resolver and the unlabeled dataset (``data/pipeline.py``) and the offline
preprocessing (``data/preprocess.py``).

- ``tile_pad_device`` / ``zero_pad_device`` equal adfmsl's jnp versions
  exactly at lengths 0, 1, 777, max_len and past it, and the host pads
  wherever both define the clip (a tile pad of length 0 clamps to 1 on the
  device, as adfmsl's does, where the host gives zeros).
- ``gen_spoof_list`` returns adfmsl's ``(labels, ids)`` in both polarities
  and its bare eval list.
- On a nested tree with exact stems, substring stems and a missing id,
  ``FuzzyAudioResolver`` resolves every id to adfmsl's path, and
  ``AsvspoofDataset(fuzzy_discovery=True, labeled=False)`` gives adfmsl's
  rows (bit for bit, through the batch path and ``load``) and labels 0.
- ``trim_silence`` and ``preprocess_audio`` are bit-equal to adfmsl's, the
  manifest CSV is byte-equal, ``validate_dataset`` and
  ``explore_data_structure`` return the same results.
"""
import dataclasses
import importlib
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adfmsl.data import pipeline as jpipe
from adfmsl.data import preprocess as jpre
from adfmsl.data import protocol as jproto
from adfmsl_torch.data import (AsvspoofDataset, FuzzyAudioResolver, SyntheticSpec,
                               create_dataset_manifest, explore_data_structure,
                               gen_spoof_list, generate_fixture, parse_protocol,
                               preprocess_audio, tile_pad, tile_pad_device, trim_silence,
                               validate_dataset, write_wav, zero_pad, zero_pad_device)

MAX_LEN = 2000
# adfmsl.data's own ``pad`` function shadows the module's name there
jpad = importlib.import_module("adfmsl.data.pad")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_tools")
    return generate_fixture(str(root / "fixture"), SyntheticSpec(n_train=6, n_dev=4,
                                                                 n_eval=4, duration=0.5))


@pytest.mark.parametrize("length", [0, 1, 777, MAX_LEN, MAX_LEN + 5])
def test_device_pads_match_adfmsl_and_the_host_pads(length):
    buf = np.random.default_rng(length).standard_normal(MAX_LEN).astype(np.float32)
    clip = buf[:length]
    for port, jax_fn, host in ((tile_pad_device, jpad.tile_pad_device, tile_pad),
                               (zero_pad_device, jpad.zero_pad_device, zero_pad)):
        got = port(torch.from_numpy(buf), torch.tensor(length), MAX_LEN)
        want = np.asarray(jax_fn(jnp.asarray(buf), jnp.asarray(length), MAX_LEN))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
        if length or port is zero_pad_device:
            assert np.array_equal(got.numpy(), host(clip, MAX_LEN))
    # a batch of buffers with a length a row, as jnp.where broadcasts it
    bufs = np.random.default_rng(1).standard_normal((3, MAX_LEN)).astype(np.float32)
    lens = np.array([[0], [5], [MAX_LEN]])
    want = np.asarray(jpad.zero_pad_device(jnp.asarray(bufs), jnp.asarray(lens), MAX_LEN))
    got = zero_pad_device(torch.from_numpy(bufs), torch.from_numpy(lens), MAX_LEN)
    assert np.array_equal(got.numpy(), want)


def test_gen_spoof_list_matches_adfmsl(fixture, tmp_path):
    proto = fixture["train"]["protocol"]
    for pol in ("bonafide1", "spoof1"):
        assert gen_spoof_list(proto, is_train=True, polarity=pol) == \
            jproto.gen_spoof_list(proto, is_train=True, polarity=pol)
    bare = tmp_path / "eval_ids.txt"
    bare.write_text("\n".join(fixture["eval"]["utt_ids"]) + "\n\n")
    got = gen_spoof_list(str(bare), is_eval=True)
    assert got == jproto.gen_spoof_list(str(bare), is_eval=True) == fixture["eval"]["utt_ids"]


@pytest.fixture(scope="module")
def nested(fixture, tmp_path_factory):
    """A tree the three fixed layouts miss: exact stems in nested dirs, a stem
    that only contains its id, an exact stem beside a longer one holding it,
    and an id with no file."""
    root = str(tmp_path_factory.mktemp("nested") / "corpus")
    src = fixture["train"]
    ids = src["utt_ids"]
    places = [("a/b", ids[0]), ("c", "pre_" + ids[1] + "_post"), ("d/e/f", ids[2]),
              ("g", "x" + ids[2] + "y"), ("h", ids[3]), ("h/i", ids[4] + "_v2")]
    for sub, stem in places:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        uid = next(u for u in ids if u in stem)
        shutil.copy(os.path.join(src["audio_dir"], uid + ".wav"),
                    os.path.join(root, sub, stem + ".wav"))
    proto = tmp_path_factory.mktemp("nested_proto") / "proto.txt"
    proto.write_text("".join(f"S {u} - - {'bonafide' if i % 2 == 0 else 'spoof'}\n"
                             for i, u in enumerate(ids)))
    return root, str(proto), ids


def test_fuzzy_resolver_and_unlabeled_dataset_match_adfmsl(nested):
    root, proto_path, ids = nested
    port, ref = FuzzyAudioResolver(root), jpipe.FuzzyAudioResolver(root)
    assert len(port) == len(ref) == 6
    got = [port.resolve(u) for u in ids + ["LA_T_9999999"]]
    assert got == [ref.resolve(u) for u in ids + ["LA_T_9999999"]]
    assert got[5] is None and got[-1] is None and all(got[:5])
    assert os.path.basename(got[2]) == ids[2] + ".wav"        # the exact stem first

    proto = parse_protocol(proto_path)
    ds = AsvspoofDataset(proto, root, cut=4000, fuzzy_discovery=True, labeled=False)
    jds = jpipe.AsvspoofDataset(jproto.parse_protocol(proto_path), root, cut=4000,
                                fuzzy_discovery=True, labeled=False)
    audio, labels = ds.load_batch(ids)
    jaudio, jlabels = jds.load_batch(ids)
    assert np.array_equal(audio, jaudio) and np.array_equal(labels, jlabels)
    assert not labels.any() and np.abs(audio[:5]).max(axis=1).min() > 0
    assert not audio[5].any()
    for u, row in zip(ids, audio):
        x, y = ds.load(u)
        assert np.array_equal(x, row) and y == 0
    # labeled, without the resolver: the fixed layouts find nothing here
    plain = AsvspoofDataset(proto, root, cut=4000)
    a2, l2 = plain.load_batch(ids)
    assert not a2.any() and list(l2) == [1, 0, 1, 0, 1, 0]


def test_trim_and_preprocess_match_adfmsl(tmp_path):
    rng = np.random.default_rng(0)
    sig = 0.5 * np.sin(2 * np.pi * 220 * np.arange(8000) / 16000).astype(np.float32)
    x = np.concatenate([np.zeros(8000, np.float32), sig,
                        1e-4 * rng.standard_normal(6000).astype(np.float32)])
    for args in ((30.0,), (20.0, 1024, 256), (60.0,)):
        got, want = trim_silence(x, *args), jpre.trim_silence(x, *args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(trim_silence(x[:100]), x[:100])
    p = str(tmp_path / "a.wav")
    write_wav(p, x, 16000)
    for kw in ({}, {"max_len": 16000, "pad_mode": "zero"}, {"trim": False, "max_len": 4000}):
        got, want = preprocess_audio(p, **kw), jpre.preprocess_audio(p, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_manifest_validation_and_explore_match_adfmsl(fixture, tmp_path):
    dev = fixture["dev"]
    proto_path = str(tmp_path / "proto.txt")
    with open(dev["protocol"]) as fh:
        text = fh.read()
    # one id with no file, and (after the manifest, which decodes every file)
    # one with an empty file
    with open(proto_path, "w") as fh:
        fh.write(text + "LA_9 LA_D_missing - A01 spoof\nLA_9 LA_D_empty - - bonafide\n")
    proto, jp = parse_protocol(proto_path), jproto.parse_protocol(proto_path)
    ours, theirs = str(tmp_path / "port.csv"), str(tmp_path / "adfmsl.csv")
    entries = create_dataset_manifest(proto, dev["audio_dir"].replace("/flac", ""), ours)
    jentries = jpre.create_dataset_manifest(jp, dev["audio_dir"].replace("/flac", ""),
                                            theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert [dataclasses.astuple(e) for e in entries] == \
        [dataclasses.astuple(e) for e in jentries]
    empty = os.path.join(dev["audio_dir"], "LA_D_empty.wav")
    open(empty, "wb").close()
    for check in (False, True):
        rep = validate_dataset(proto, dev["audio_dir"], check_decode=check)
        jrep = jpre.validate_dataset(jp, dev["audio_dir"], check_decode=check)
        assert dataclasses.astuple(rep) == dataclasses.astuple(jrep)
        assert rep.missing == ["LA_D_missing"] and rep.empty == ["LA_D_empty"]
        assert not rep.ok and rep.found == len(proto) - 1
    os.remove(empty)
    root = os.path.dirname(os.path.dirname(dev["audio_dir"]))
    for kw in ({}, {"max_depth": 1}, {"max_entries": 2}):
        assert explore_data_structure(root, **kw) == jpre.explore_data_structure(root, **kw)
