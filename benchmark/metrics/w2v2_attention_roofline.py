"""WavLM's attention's share of its roofline: the least time of a forward's
attention, from the cell's shapes whatever implements it
(``benchlib/attention_roofline.py``: the 24 layers' scores and weighted sums,
4 * B * H * T'^2 * d_h products a layer, at the bf16 peak, or q, k, v read
once and the output written once in bf16 at the HBM rate, the larger), over
the device time a forward of ``w2v2_attention_ms.eval``. A program without
the attention's spans reads nothing."""
from benchlib.attention_roofline import attention_bound_ms
from benchlib.readers import load_reader

UNIT = "%"


def read(ctx):
    measured_ms = load_reader("w2v2_attention_ms.eval").read(ctx)
    if not measured_ms:
        return None
    w, trf = ctx.cell.config["w2v2"], ctx.cell.traffic
    heads = w["num_attention_heads"]
    t = ctx.ref.frames(w, trf["cut"])[-1]
    bound_ms = attention_bound_ms(trf["batch"], t, heads, w["hidden_size"] // heads,
                                  w["num_hidden_layers"])
    return 100.0 * bound_ms / measured_ms
