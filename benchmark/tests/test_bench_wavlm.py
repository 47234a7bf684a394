"""The WavLM cell (``maze6_wavlm.eval.30s.b16``) on the CPU at a small size:
its configuration through the same ``load_cell`` path with the port's
'tiny_wavlm' encoder (2 layers, 4 heads, 32 buckets up to distance 64), 8
clips of 4,000 samples, float32; its three readers on a synthetic trace."""
import copy

import pytest
import torch

from benchlib import common, eval_driver, readers
from benchlib.attention_roofline import attention_bound_ms
from benchlib.trace import Trace
from reference import wavlm_maze

from adfmsl_torch.utils import profiling
from adfmsl_torch.utils.profiling import Recorded, Span

CELL = "maze6_wavlm.eval.30s.b16"
DEV = torch.device("cpu")
SEED = 2 ** 31 + 23
TINY_WAVLM = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "conv_dim": [32, 32], "conv_kernel": [10, 3],
              "conv_stride": [5, 2], "num_buckets": 32, "max_bucket_distance": 64}
NEW = ("w2v2_attention_ms.eval", "w2v2_relpos_ms.eval", "w2v2_attention_roofline")


def small_wavlm_cell():
    cfg = copy.deepcopy(common.load_json("configs", "maze6_wavlm.json"))
    cfg["program"]["overrides"] = {"model.wav2vec2.model_name": "tiny_wavlm",
                                   "model.dtype": "float32"}
    cfg["w2v2"].update(TINY_WAVLM)
    trf = dict(common.load_json("traffic", "eval.30s.b16.json"))
    trf.update(utterances=8, cut=4000, batch=4, check_rows=8, check_block=4,
               calibration_rows=4)
    return common.load_cell(CELL, cfg, trf)


def test_the_cell_reports_its_metrics():
    cell = common.load_cell(CELL)
    assert cell.chips == 1 and cell.end_to_end == ["eval_utt_per_s", "setup_s"]
    assert set(NEW) <= set(cell.per_layer) and "K1_roofline" in cell.per_layer
    assert "w2v2_encoder_ms.eval" not in cell.per_layer          # superseded


def test_scores_agree_with_the_reference_in_float32():
    """Scores within 1e-4 (float32 reads about 1e-6)."""
    r = eval_driver.run(small_wavlm_cell(), SEED, 0.1, False, DEV)
    assert r.failed == 0 and r.checks["score_gap"]["value"] < 1e-4, r.checks


def test_a_program_without_the_gated_bias_is_wrong(monkeypatch):
    from adfmsl_torch.models.w2v2 import Wav2Vec2Encoder

    monkeypatch.setattr(Wav2Vec2Encoder, "position_bias",
                        lambda self, t: torch.zeros(self.arch.num_heads, t, t))
    r = eval_driver.run(small_wavlm_cell(), SEED, 0.1, False, DEV)
    assert r.checks["score_gap"]["value"] > 1e-2, r.checks


def test_a_program_without_wavlm_fails_at_once():
    """The reference refuses a state dict with no bucket table (a program
    that built wav2vec2 for the WavLM name) before any product."""
    cell = small_wavlm_cell()
    with pytest.raises(KeyError, match="rel_attn_embed"):
        wavlm_maze.scores({}, torch.zeros(1, 4000), cell.config, None)


def _span(name, start_us, end_us, parent=None):
    return Span(name, int(start_us * 1e3), int(end_us * 1e3), parent, None)


def test_readers_take_the_attention_spans_by_parent(monkeypatch):
    """The bias table once, two layers' attention with the gate inside each:
    kernels at 0-10 (the table), 20-30 (scores), 30-35 (gate), 40-50 (outside
    any), 60-70 (the second layer's scores), 70-72 (its gate)."""
    spans = [_span("stage.w2v2.relpos", 0, 1, "stage.model.frontend"),
             _span("stage.w2v2.gate", 2, 3, "stage.w2v2.attention"),
             _span("stage.w2v2.attention", 2, 4, "stage.model.frontend"),
             _span("stage.w2v2.gate", 6, 7, "stage.w2v2.attention"),
             _span("stage.w2v2.attention", 6, 8, "stage.model.frontend")]
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded(spans, {}))
    trace = Trace(kernels=[(0.0, 10.0, "t"), (20.0, 30.0, "s"), (30.0, 35.0, "g"),
                           (40.0, 50.0, "x"), (60.0, 70.0, "s"), (70.0, 72.0, "g")])
    trace.device_spans = {"stage.w2v2.relpos": [(0.0, 11.0)],
                          "stage.w2v2.attention": [(19.0, 30.0), (59.0, 70.0)],
                          "stage.w2v2.gate": [(30.0, 36.0), (70.0, 73.0)]}
    cell = common.load_cell(CELL)
    ctx = readers.Context(cell=cell, ref=wavlm_maze, trace=trace, calls=2)
    got = {k: v["value"] for k, v in readers.read_all(list(NEW), ctx).items()}
    bound = attention_bound_ms(16, 1499, 16, 64, 24)
    assert got == pytest.approx({"w2v2_attention_ms.eval": 0.0185,      # 37 us / 2
                                 "w2v2_relpos_ms.eval": 0.0085,         # 17 us / 2
                                 "w2v2_attention_roofline": 100 * bound / 0.0185})
    assert bound == pytest.approx(3.5735, rel=1e-4)     # the products bound it


def test_readers_read_nothing_from_a_program_without_the_spans(monkeypatch):
    trace = Trace(kernels=[(0.0, 10.0, "a")])
    trace.device_spans = {"stage.model.frontend": [(0.0, 10.0)]}
    ctx = readers.Context(cell=common.load_cell(CELL), ref=wavlm_maze, trace=trace,
                          calls=2)
    monkeypatch.setattr(profiling, "recorded",
                        lambda: Recorded([_span("stage.model.frontend", 0, 1)], {}))
    assert readers.read_all(list(NEW), ctx) == {}
    monkeypatch.delattr(profiling, "recorded")
    assert readers.read_all(list(NEW), ctx) == {}
