"""The whole forward's share of the card's bf16 peak: the products of one
utterance's forward counted from the configuration's shapes (its reference's
``forward_flops``), times the utterances scored, over the traced window's
seconds and 989 TFLOP/s (H100 SXM, dense bf16)."""
from benchlib.roofline import PEAKS

UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.rows or ctx.window_s <= 0:
        return None
    flops = ctx.ref.forward_flops(ctx.cell.config, ctx.cell.traffic["cut"]) * ctx.rows
    return 100.0 * flops / ctx.window_s / PEAKS["bf16_flops"]
