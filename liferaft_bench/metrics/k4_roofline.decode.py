"""K4's share of its roofline over the traced window (%): the bound of
every decode-attention call (each sequence's attended K/V read once, q
and the output) over K4's summed device time.  Nothing where the trace
holds no K4 launch, or not one a layer a step (a launch lost)."""
from liferaft_bench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound, k4_call
from liferaft_bench.trace import is_k4


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = ctx.spec
    secs = t.seconds(is_k4)
    if secs <= 0 or t.count(is_k4) != ctx.steps * s.n_layers:
        return None
    peak = PEAK_BF16_FLOPS if ctx.itemsize == 2 else PEAK_FP32_FLOPS
    ms = sum(bound(*k4_call(ctx.batch, s.n_heads, s.n_kv_heads, s.head_dim,
                            pos + 1, ctx.itemsize), peak)[0]
             for pos in ctx.positions) * s.n_layers
    return 100.0 * ms / 1e3 / secs
