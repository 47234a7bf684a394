"""Peaks of the card and the kernels' least times.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): the rates a share is taken against. ``k1_bound_ms`` is K1's least
time for one call, copied from ``chip_smoke.py:k1_bound``: its conv products
at the bf16 tensor-core peak, against x read once, y and the sums written
once and the operands read once at the HBM rate; the bound is the larger.
"""
from __future__ import annotations

PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "f32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}


def k1_bound_ms(b: int, t: int, cin: int, cout: int, pre: bool, skip: bool,
                pool: int = 1) -> float:
    per_row = 3 * cin * cout + 3 * cout * cout + (cin * cout if skip else 0)
    flops = 2.0 * b * t * per_row
    nbytes = (2 * b * t * cin + 2 * b * (t // pool) * cout + 4 * b * cout
              + 2 * per_row + 4 * 2 * cout + (4 * 2 * cin if pre else 0))
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes"]) * 1e3
