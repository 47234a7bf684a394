"""The least time of an encoder's self-attention, from its shapes alone.

Whatever computes the attention (library products with the score matrix in
memory, or one fused kernel), its work is the same: in each layer the scores
q.k and the weighted sum w.v, 2 * B * H * T^2 * d_h products each, and q, k
and v read once and the output written once, in bfloat16. The least time is
the larger of the products at the bf16 tensor-core peak and those bytes at
the HBM rate (``benchlib/roofline.py``'s peaks). A materialised score matrix,
a bias or a softmax pass is an implementation's cost and not part of the
bound.
"""
from __future__ import annotations

from benchlib.roofline import PEAKS


def attention_bound_ms(b: int, t: int, heads: int, head_dim: int, layers: int) -> float:
    """One forward's least attention time over ``layers`` layers."""
    flops = 4.0 * b * heads * t * t * head_dim * layers
    nbytes = 2.0 * 4 * b * t * heads * head_dim * layers
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes"]) * 1e3
