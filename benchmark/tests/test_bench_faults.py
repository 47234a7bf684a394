"""The correctness check fails a broken timed path: each fault the cells can
have, planted under a CPU run at a small size, and the control (the
reference in float8 where the configuration states bfloat16) in the
program's place. The limits are the cells' own."""
import pytest
import torch

import calibrate
from benchlib import common, eval_driver, train_driver
from small import small_cell

DEV = torch.device("cpu")
SEED = 2 ** 31 + 17


def _patch_scores(monkeypatch, change):
    from adfmsl_torch.models.mazes import MazeModel

    forward = MazeModel.forward

    def broken(self, x, *a, **kw):
        out = forward(self, x, *a, **kw)
        out["scores"] = change(out["scores"])
        return out
    monkeypatch.setattr(MazeModel, "forward", broken)


@pytest.mark.parametrize("name", ["maze5_fmsl.eval.b128", "maze6.eval.b128"])
def test_eval_sound_run_is_correct(name):
    assert eval_driver.run(small_cell(name), SEED, 0.1, False, DEV).correct


@pytest.mark.parametrize("name", ["maze5_fmsl.eval.b128", "maze6.eval.b128"])
def test_eval_answer_altered_where_produced(monkeypatch, name):
    _patch_scores(monkeypatch, lambda s: s + torch.where(
        torch.arange(len(s)) == 0, 1.0, 0.0).to(s))
    r = eval_driver.run(small_cell(name), SEED, 0.1, False, DEV)
    assert not r.correct and r.checks["score_gap"]["value"] > r.checks["score_gap"]["limit"]


@pytest.mark.parametrize("name", ["maze5_fmsl.eval.b128", "maze6.eval.b128"])
def test_eval_half_the_batch_left_out(monkeypatch, name):
    _patch_scores(monkeypatch, lambda s: s[: len(s) // 2])
    r = eval_driver.run(small_cell(name), SEED, 0.1, False, DEV)
    assert not r.correct and r.failed > 0


@pytest.mark.parametrize("name,rows", [("maze5_fmsl.eval.b128", 32), ("maze6.eval.b128", 16)])
def test_eval_control_is_not_correct(name, rows):
    """At the published widths (maze6's whole encoder: the 'tiny' one is too
    shallow for its error to build up) and half-second clips."""
    cell = common.load_cell(name)
    cell.traffic.update(utterances=rows, check_rows=rows, check_block=8, calibration_rows=8,
                        cut=8000)
    readings = calibrate.controls(cell, [1, 2, 3], DEV)
    assert not any(r["correct"] for r in readings), readings


def test_train_sound_run_is_correct():
    assert train_driver.run(small_cell("maze5_fmsl.train.b32"), SEED, 0.1, False, DEV).correct


def test_train_step_that_leaves_the_state_unchanged(monkeypatch):
    from adfmsl_torch.train.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)
    r = train_driver.run(small_cell("maze5_fmsl.train.b32"), SEED, 0.1, False, DEV)
    assert not r.correct and r.checks["change_gap"]["value"] == pytest.approx(1.0)
    assert r.checks["grad_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out():
    r = train_driver.run(small_cell("maze5_fmsl.train.b32"), SEED, 0.1, False, DEV,
                         fault=train_driver.half_batch)
    assert not r.correct
    assert r.checks["loss_gap_first"]["value"] > r.checks["loss_gap_first"]["limit"]


def test_train_control_is_not_correct():
    readings = calibrate.controls(small_cell("maze5_fmsl.train.b32"), [1, 2, 3], DEV)
    assert not any(r["correct"] for r in readings), readings
