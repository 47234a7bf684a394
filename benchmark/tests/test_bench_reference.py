"""The references against the port's CPU path, both in float32, through the
benchmark's own drivers: the same weights, rows and random draws must give
the same numbers up to float32 rounding."""
import torch

from benchlib import eval_driver, train_driver
from small import small_cell

DEV = torch.device("cpu")


def test_eval_references_agree_with_the_port_in_float32():
    """Scores within 1e-4 of the reference scores' spread (float32 reads
    about 3e-6)."""
    for name in ("maze5_fmsl.eval.b128", "maze6.eval.b128"):
        r = eval_driver.run(small_cell(name, "float32"), 2 ** 31 + 11, 0.1, False, DEV)
        assert r.failed == 0 and r.checks["score_gap"]["value"] < 1e-4, (name, r.checks)


def test_train_reference_agrees_with_the_port_in_float32():
    """The first step's loss within 1e-5 and its gradient within 1e-4 by the
    worst leaf (float32 reads about 5e-7 and 4e-6). The change moves further,
    to 5e-3 on the seeds tried: AdamW's first steps are lr * sign(g) on
    elements whose gradient is at the rounding level, so round-off there
    moves them a full step either way."""
    r = train_driver.run(small_cell("maze5_fmsl.train.b32", "float32"), 2 ** 31 + 13, 0.1,
                         False, DEV)
    c = r.checks
    assert c["grad_gap"]["value"] < 1e-4 and c["loss_gap_first"]["value"] < 1e-5, c
    assert c["change_gap"]["value"] < 3e-2 and c["rows"]["value"] == 0, c
