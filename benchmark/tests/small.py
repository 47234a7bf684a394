"""Cells of the benchmark at sizes a CPU test holds: the configurations'
published widths where the CPU can run them (maze5_fmsl), the 'tiny' encoder
where it cannot (maze6), and a few short clips."""
import copy

from benchlib import common

TINY_W2V2 = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 128, "conv_dim": [32, 32], "conv_kernel": [10, 3],
             "conv_stride": [5, 2]}


def small_cell(name: str, program_dtype=None):
    w = next(x for x in common.manifest()["workloads"] if x["name"] == name)
    cfg = copy.deepcopy(common.load_json("configs", w["config"] + ".json"))
    trf = dict(common.load_json("traffic", w["traffic"] + ".json"))
    if "w2v2" in cfg:
        cfg["program"]["overrides"] = {"model.wav2vec2.model_name": "tiny"}
        cfg["w2v2"].update(TINY_W2V2)
    if program_dtype:
        cfg["program"].setdefault("overrides", {})["model.dtype"] = program_dtype
    if trf["driver"] == "eval":
        trf.update(utterances=8, cut=4000, batch=4, check_rows=8, check_block=4,
                   calibration_rows=4)
    else:
        trf.update(utterances=96, cut=4000, batch=32)
    return common.load_cell(name, cfg, trf)
