"""Each cell end to end on the card: a short run of ``run.py`` per cell,
plain and traced, prints a correct result with the cell's metrics. Skips
where no card is visible. Run on the card with
``python -m pytest benchmark/tests/test_bench_card.py -m cuda``."""
import json
import os
import subprocess
import sys

import pytest

from benchlib import common

CELLS = ["maze5_fmsl.eval.b128", "maze6.eval.b128", "maze5_fmsl.train.b32"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(common.BENCH_DIR, "run.py"),
                          "--workload", name, "--seed", str(2 ** 31 + 101), "--seconds", "3",
                          "--trace", str(trace)], capture_output=True, text=True,
                         cwd=common.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    cell = common.load_cell(name)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(cell.per_layer if trace else cell.end_to_end)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
