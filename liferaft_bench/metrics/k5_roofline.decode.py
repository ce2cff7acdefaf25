"""K5's share of its roofline over the traced window (%): the bound of
every grouped product (the weights of the experts its routing made
active, read once, and the routed rows of x and y) over K5's summed device
time.  Nothing where the cell has no experts; an error where the trace's
K5 launches are not the calls the probe recorded (the port's call into K5
changed, so the bytes would be counted for other calls)."""
from liferaft_bench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound, k5_call
from liferaft_bench.trace import is_k5


def read(ctx):
    t, calls = ctx.trace, ctx.k5_calls
    if t is None or not calls:
        return None
    secs = t.seconds(is_k5)
    if secs <= 0 or t.count(is_k5) != len(calls):
        raise RuntimeError(f"K5: {t.count(is_k5)} launches in the trace, "
                           f"{len(calls)} calls recorded")
    ms = sum(bound(*k5_call(*c),
                   PEAK_BF16_FLOPS if c[4] == 2 else PEAK_FP32_FLOPS)[0]
             for c in calls)
    return 100.0 * ms / 1e3 / secs
