"""Packs in the port (``adfmsl_torch/data/pack.py``, ``cli/pack.py``, the
evaluate CLI's ``--pack`` and the train CLI's ``--train_pack`` /
``--dev_pack`` / ``--eval_pack``) against adfmsl's and against the audio path.

At cut 4000 on the synthetic fixture (12 train, 8 dev and 8 eval
utterances), exactly (``np.array_equal``, byte-equal files, ``torch.equal``):

- a pack's batches are the audio path's (written 7 rows a chunk, fewer than
  N), shuffled too, and its metadata is adfmsl's keys;
- a port-written pack loads in adfmsl's ``PackedDataset`` and an
  adfmsl-written one in the port's, with equal arrays and metadata;
- labels come from the caller's protocol ('spoof1'), and a protocol id
  missing from the pack raises ``KeyError`` naming the count and the ids;
- a full batch is the pack's rows in the asked order, copied once; a short
  one is padded with zero rows;
- ``DataLoader(rank=r, world=2)`` over a pack reads only its own row block
  of each global batch, and the two blocks make the world-of-one batch;
- ``cli.pack`` writes adfmsl's ``cli.pack`` arrays and prints its line;
- maze5 ``cli.evaluate --pack --device cpu`` writes ``--data_dir``'s score
  file byte for byte, the pack's clip length overriding an explicit
  ``--cut`` with a warning;
- one epoch of ``cli.train --train_pack --dev_pack`` (maze5) leaves the
  checkpoint of the same run from ``--train_dir`` / ``--dev_dir`` bit for bit (the pack's
  cut replaces the config's and ``experiment.yaml`` records it), and
  ``--eval --eval_pack`` writes ``--eval --eval_dir``'s score file.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

from adfmsl.cli import pack as jax_pack_cli
from adfmsl.data import PackedDataset as JaxPackedDataset
from adfmsl.data import create_pack as jax_create_pack
from adfmsl.data import parse_protocol as jax_parse_protocol
from adfmsl_torch.data import (AsvspoofDataset, DataLoader, PackedDataset, SyntheticSpec,
                               create_pack, generate_fixture, parse_protocol)

CUT, BATCH = 4000, 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the machine's cores: torch's own
    thread pool in every worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    return generate_fixture(str(root / "fixture"), SyntheticSpec(n_train=12, n_dev=8,
                                                                 n_eval=8))


@pytest.fixture(scope="module")
def packs(fixture, tmp_path_factory):
    """The three splits packed by the port at cut 4000, 7 rows a chunk."""
    root = tmp_path_factory.mktemp("packs")
    out = {}
    for split in ("train", "dev", "eval"):
        f = fixture[split]
        out[split] = str(root / split)
        create_pack(parse_protocol(f["protocol"]), f["audio_dir"], out[split], cut=CUT,
                    batch=7)
    return out


def _batches(ds, **kw):
    return list(DataLoader(ds, 8, prefetch=0, **kw))


def test_pack_batches_equal_the_audio_path(fixture, packs):
    f = fixture["train"]
    proto = parse_protocol(f["protocol"])
    ref, got = AsvspoofDataset(proto, f["audio_dir"], cut=CUT), PackedDataset(packs["train"], proto)
    assert len(got) == len(proto) and got.cut == CUT and got.pad_mode == "tile"
    for kw in ({"shuffle": False}, {"shuffle": True, "seed": 7}):
        a, b = _batches(ref, **kw), _batches(got, **kw)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert np.array_equal(x.audio, y.audio) and np.array_equal(x.label, y.label)
            assert np.array_equal(x.mask, y.mask) and x.utt_ids == y.utt_ids
    with open(packs["train"] + ".json") as fh:
        meta = json.load(fh)
    assert sorted(meta) == ["cut", "labels", "pad_mode", "sample_rate", "utt_ids"]
    assert meta["utt_ids"] == f["utt_ids"] and meta["labels"] == proto.labels
    # without a protocol the labels come from the metadata
    x, y = PackedDataset(packs["train"]).load(f["utt_ids"][1])
    assert y == proto.labels[f["utt_ids"][1]] and np.array_equal(x, ref.load(f["utt_ids"][1])[0])


@pytest.mark.parametrize("writer", ["port", "adfmsl"])
def test_packs_load_in_the_other_package(writer, fixture, tmp_path):
    f = fixture["dev"]
    prefix = str(tmp_path / "p")
    if writer == "port":
        create_pack(parse_protocol(f["protocol"]), f["audio_dir"], prefix, cut=CUT, batch=3)
    else:
        jax_create_pack(jax_parse_protocol(f["protocol"]), f["audio_dir"], prefix, cut=CUT,
                        batch=3)
    ours, theirs = PackedDataset(prefix), JaxPackedDataset(prefix)
    ids = f["utt_ids"]
    a, la = ours.load_batch(ids[::-1])
    b, lb = theirs.load_batch(ids[::-1])
    assert a.shape == (len(ids), CUT) and np.array_equal(a, b) and np.array_equal(la, lb)
    assert (ours.cut, ours.pad_mode, ours.sample_rate) == \
        (theirs.cut, theirs.pad_mode, theirs.sample_rate)
    assert ours.protocol.utt_ids == theirs.protocol.utt_ids == ids
    # and the two writers write the same pack
    other = str(tmp_path / "q")
    (jax_create_pack(jax_parse_protocol(f["protocol"]), f["audio_dir"], other, cut=CUT)
     if writer == "port" else
     create_pack(parse_protocol(f["protocol"]), f["audio_dir"], other, cut=CUT))
    assert np.array_equal(np.load(prefix + ".npy"), np.load(other + ".npy"))
    with open(prefix + ".json") as x, open(other + ".json") as y:
        assert json.load(x) == json.load(y)


def test_caller_protocol_gives_labels_and_missing_ids_raise(fixture, packs, tmp_path):
    f = fixture["train"]
    flipped = parse_protocol(f["protocol"], "spoof1")
    ds = PackedDataset(packs["train"], flipped)
    _, labels = ds.load_batch(f["utt_ids"])
    assert list(labels) == [flipped.labels[u] for u in f["utt_ids"]] == \
        [1 - parse_protocol(f["protocol"]).labels[u] for u in f["utt_ids"]]
    _, jlabels = JaxPackedDataset(packs["train"], jax_parse_protocol(
        f["protocol"], "spoof1")).load_batch(f["utt_ids"])
    assert np.array_equal(labels, jlabels)
    extra = tmp_path / "extra.txt"
    with open(f["protocol"]) as fh:
        extra.write_text(fh.read() + "S LA_T_extra1 - A01 spoof\nS LA_T_extra2 - - bonafide\n")
    with pytest.raises(KeyError, match=r"2 protocol utterances missing from pack "
                                       r"\(first: \['LA_T_extra1', 'LA_T_extra2'\]\)"):
        PackedDataset(packs["train"], parse_protocol(str(extra)))


def test_full_batches_hand_on_the_loaded_rows_and_short_ones_pad(fixture, packs):
    """``load_batch`` copies each row once into its place in the asked order; a
    full batch is that array (writable, C-contiguous), a short one its rows
    padded with zero rows."""
    from adfmsl_torch.data.pipeline import _make_batch

    f = fixture["train"]
    ds = PackedDataset(packs["train"], parse_protocol(f["protocol"]))
    rows = np.load(packs["train"] + ".npy")
    order = [5, 0, 11, 3, 7, 2, 9, 1]
    full = _make_batch(ds, [f["utt_ids"][i] for i in order], 8)
    assert np.array_equal(full.audio, rows[order]) and full.mask.all()
    assert full.audio.flags.writeable and full.audio.flags.c_contiguous
    short = _make_batch(ds, [f["utt_ids"][i] for i in order[:3]], 8)
    assert short.audio.shape == (8, CUT) and not short.audio[3:].any()
    assert np.array_equal(short.audio[:3], rows[order[:3]])
    assert short.mask.tolist() == [True] * 3 + [False] * 5


def test_rank_blocks_read_only_their_rows(fixture, packs):
    proto = parse_protocol(fixture["train"]["protocol"])

    def loader(rank, world):
        ds = PackedDataset(packs["train"], proto)
        read = []
        load_batch = ds.load_batch
        ds.load_batch = lambda ids: (read.append(list(ids)), load_batch(ids))[1]
        return DataLoader(ds, 5, shuffle=True, seed=3, prefetch=0, rank=rank,
                          world=world), read

    one, _ = loader(0, 1)
    whole = list(one)
    blocks = []
    for r in (0, 1):
        ld, read = loader(r, 2)
        got = list(ld)
        assert read == [[u for u in b.utt_ids if u] for b in got if any(b.utt_ids)]
        assert all(b.global_ids[3 * r:3 * r + 3] == b.utt_ids for b in got)
        blocks.append(got)
    assert len(whole) == len(blocks[0]) == len(blocks[1]) == 3
    for w, b0, b1 in zip(whole, *blocks):
        audio = np.concatenate([b0.audio, b1.audio])
        mask = np.concatenate([b0.mask, b1.mask])
        assert np.array_equal(audio[:5], w.audio) and not audio[5:].any()
        assert np.array_equal(mask[:5], w.mask) and not mask[5:].any()
        assert b0.utt_ids + b1.utt_ids == w.utt_ids + [""]


def test_cli_pack_matches_adfmsl_cli_pack(fixture, tmp_path, capsys):
    from adfmsl_torch.cli import pack

    f = fixture["eval"]
    args = ["--protocol", f["protocol"], "--data_dir", f["audio_dir"], "--cut", str(CUT),
            "--polarity", "spoof1", "--num_workers", "2"]
    assert pack.main(args + ["--out_prefix", str(tmp_path / "port")]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"packed 8 utterances -> {tmp_path / 'port'}.npy (")
    assert line.endswith(" utt/s decode)")
    assert jax_pack_cli.main(args + ["--out_prefix", str(tmp_path / "adfmsl")]) == 0
    assert np.array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "adfmsl.npy"))
    with open(tmp_path / "port.json") as x, open(tmp_path / "adfmsl.json") as y:
        assert json.load(x) == json.load(y)


def test_evaluate_from_a_pack_equals_the_audio_path(fixture, packs, tmp_path, caplog,
                                                    capsys):
    from adfmsl_torch.cli import evaluate

    f = fixture["eval"]
    common = ["--model_type", "maze5", "--protocol", f["protocol"], "--batch_size", "3",
              "--device", "cpu"]
    out = {k: str(tmp_path / f"{k}.txt") for k in ("dir", "pack")}
    assert evaluate.main(common + ["--data_dir", f["audio_dir"], "--cut", str(CUT),
                                   "--output", out["dir"]]) == 0
    caplog.set_level(logging.INFO)
    assert evaluate.main(common + ["--pack", packs["eval"], "--cut", "8000",
                                   "--output", out["pack"]]) == 0
    warned = [r for r in caplog.records if "clip length comes from the pack" in r.getMessage()]
    assert len(warned) == 1 and warned[0].levelno == logging.WARNING
    assert "4000 (config had 8000 — the explicit --cut is overridden)" in warned[0].getMessage()
    with open(out["dir"], "rb") as a, open(out["pack"], "rb") as b:
        text = a.read()
        assert text == b.read()
    assert [ln.split()[0] for ln in text.decode().splitlines()] == f["utt_ids"]
    with pytest.raises(SystemExit):
        evaluate.main(common)
    assert "one of --data_dir or --pack is required" in capsys.readouterr().err


def _small(cut):
    """maze5 at batch 4 (eval batch 4: a padded batch of 128 rows would cost
    most of the test)."""
    def patch(exp):
        exp.data.cut, exp.data.prefetch = cut, 0
        exp.train.batch_size, exp.train.num_epochs, exp.train.log_every_steps = BATCH, 1, 0
        exp.train.eval_batch_size = BATCH
        return exp
    return patch


def test_train_from_packs_equals_train_from_audio(fixture, packs, tmp_path, monkeypatch):
    import adfmsl_torch.config as config
    from adfmsl_torch.cli import train as cli_train
    from adfmsl_torch.config import load_yaml
    from adfmsl_torch.models import load_checkpoint

    make = config.make_experiment
    tr, dv, ev = fixture["train"], fixture["dev"], fixture["eval"]
    common = ["--model", "maze5", "--train_protocol", tr["protocol"], "--dev_protocol",
              dv["protocol"], "--device", "cpu"]
    runs = {"dir": (CUT, ["--train_dir", tr["audio_dir"], "--dev_dir", dv["audio_dir"]],
                    ["--eval_dir", ev["audio_dir"]]),
            # the config's cut differs: the pack's replaces it
            "pack": (8000, ["--train_pack", packs["train"], "--dev_pack", packs["dev"]],
                     ["--eval_pack", packs["eval"]])}
    states, scores = {}, {}
    for name, (cut, data, eval_data) in runs.items():
        monkeypatch.setattr(config, "make_experiment",
                            lambda *a, _p=_small(cut), **k: _p(make(*a, **k)))
        ck = str(tmp_path / name)
        assert cli_train.main(common + data + ["--checkpoint_dir", ck]) == 0
        exp, states[name] = load_checkpoint(ck)
        assert exp.data.cut == load_yaml(os.path.join(ck, "experiment.yaml")).data.cut == CUT
        scores[name] = str(tmp_path / f"{name}_scores.txt")
        assert cli_train.main(common + data + eval_data + [
            "--checkpoint_dir", ck, "--restore", "--eval", "--eval_protocol", ev["protocol"],
            "--eval_output", scores[name]]) == 0
    assert states["dir"].keys() == states["pack"].keys()
    for k, v in states["dir"].items():
        assert torch.equal(v, states["pack"][k]), k
    with open(scores["dir"], "rb") as a, open(scores["pack"], "rb") as b:
        text = a.read()
        assert text == b.read()
    assert len(text.decode().splitlines()) == len(ev["utt_ids"])
