"""BENCHMARK.json against the contract's form, and against the cells' files."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchlib import common

MANIFEST = os.path.join(common.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as fh:
        return json.load(fh)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_units_and_lines(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) for p in manifest["paths"])
    assert len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(manifest["paths"][0] + "/")
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert os.path.getsize(MANIFEST) <= 64 * 1024


def test_cells_configurations_and_readers_have_their_files(manifest):
    """Each cell has its limits' file and finds its configuration, traffic and
    metrics by name; each configuration's file is its own and holds the
    keys its reference reads; each per-layer metric has its reader with the
    manifest's unit."""
    from benchlib import readers

    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        cfg = common.load_json("configs", c["name"] + ".json")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.chips == w["chips"]
        assert cell.traffic["driver"] in ("eval", "train") and cell.limits
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    for m in manifest["per_layer"]:
        assert readers.load_reader(m["name"]).UNIT == m["unit"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(cell in m["workloads"] for m in manifest["per_layer"])
        assert any(cell in m.get("workloads", cells) for m in manifest["end_to_end"]
                   if m["name"] != "setup_s")


def test_a_new_cell_configuration_and_metric_are_found_by_name(tmp_path, manifest):
    """Files added to a copy of the benchmark's folder are found by name,
    with no file that exists edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(common.BENCH_DIR, copy, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    m = json.loads(json.dumps(manifest))
    cfg = common.load_json("configs", "maze5_fmsl.json")
    cfg["name"] = "maze5_new"
    (copy / "configs" / "maze5_new.json").write_text(json.dumps(cfg))
    (copy / "workloads" / "maze5_new.eval.b128.json").write_text(json.dumps(
        {"correct": {"score_gap": 1.0}}))
    (copy / "metrics" / "rows_per_call.eval.py").write_text(
        'UNIT = "utt"\n\n\ndef read(ctx):\n    return ctx.rows / ctx.calls if ctx.calls else None\n')
    m["configs"].append({"name": "maze5_new", "source": "s", "file": "benchmark/configs/maze5_new.json",
                         "reduced": [], "why": "w"})
    m["workloads"].append({"name": "maze5_new.eval.b128", "config": "maze5_new",
                           "traffic": "eval.b128", "chips": 1, "why": "w"})
    for e in m["end_to_end"]:
        if e["name"] == "eval_utt_per_s":
            e["workloads"].append("maze5_new.eval.b128")
    m["per_layer"].append({"name": "rows_per_call.eval", "unit": "utt", "better": "higher",
                           "source": "host_clock", "layer": "runner", "moves": "eval_utt_per_s",
                           "workloads": ["maze5_new.eval.b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys; sys.path[:0] = [sys.argv[1]]\n"
            "from benchlib import common, readers\n"
            "cell = common.load_cell('maze5_new.eval.b128')\n"
            "ctx = readers.Context(cell=cell, ref=None, rows=256, calls=2)\n"
            "print(cell.config['name'], cell.end_to_end, readers.read_all(cell.per_layer, ctx))\n")
    out = subprocess.run([sys.executable, "-c", code, str(copy)], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == ("maze5_new ['eval_utt_per_s', 'setup_s'] "
                           "{'rows_per_call.eval': {'value': 128.0, 'unit': 'utt'}}")
