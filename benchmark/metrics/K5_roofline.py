"""K5's share of its roofline: the least time of the window's K5 calls over
the device time of K5's kernel (the union of the intervals of
``sinc_bn_act_kernel``). A call's least time, from the cell's shapes, is the
larger of its correlation's 2*B*T'*C*K products at the TF32 tensor-core peak
and its bytes (the f32 waveform and filters read once, the (B, T', C) bf16
output written once) at the HBM rate. A program without K5 reads nothing."""
from benchlib.roofline import PEAKS

UNIT = "%"
KERNELS = ("sinc_bn_act_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    from benchlib.trace import union_us

    measured_us = union_us(ctx.trace.kernel_intervals(KERNELS))
    if measured_us <= 0:
        return None
    cfg, trf = ctx.cell.config, ctx.cell.traffic
    b, t, c, k = trf["batch"], trf["cut"], cfg["sinc_filters"], cfg["sinc_kernel"]
    t_out = t - k + 1
    flops = 2.0 * b * t_out * c * k
    nbytes = 4 * b * t + 2 * b * t_out * c + 4 * c * k
    bound_ms = max(flops / PEAKS["tf32_flops"], nbytes / PEAKS["hbm_bytes"]) * 1e3
    return 100.0 * bound_ms * ctx.calls * 1e3 / measured_us
