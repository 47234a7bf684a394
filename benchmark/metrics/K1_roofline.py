"""K1's share of its roofline: the least time of the window's K1 calls
(``benchlib.roofline.k1_bound_ms`` at each call's shape, from the
configuration's reference) over the device time of K1's kernels (the union
of the intervals of ``resblock_eval_kernel`` and ``reduce_partials_kernel``)."""
from benchlib.roofline import k1_bound_ms

UNIT = "%"
KERNELS = ("resblock_eval_kernel", "reduce_partials_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    from benchlib.trace import union_us

    measured_us = union_us(ctx.trace.kernel_intervals(KERNELS))
    if measured_us <= 0:
        return None
    b = ctx.cell.traffic["batch"]
    bound_ms = sum(k1_bound_ms(b, t, cin, cout, pre, skip)
                   for t, cin, cout, pre, skip in ctx.ref.k1_calls(ctx.cell.config,
                                                                    ctx.cell.traffic["cut"]))
    return 100.0 * bound_ms * ctx.calls * 1e3 / measured_us
