"""The whole decode step's share of the card's bf16 peak (%): the model
FLOPs of every token delivered in the untraced first half of the traced
run's window (2 x the parameters it multiplies, plus attention over its
context) over that half's length (host clock) times 989 TFLOP/s.  The
profiler's own cost stays out of it."""
from liferaft_bench.roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, token_flops


def read(ctx):
    if ctx.trace is None or ctx.untraced_s <= 0:
        return None
    peak = PEAK_BF16_FLOPS if ctx.itemsize == 2 else PEAK_FP32_FLOPS
    flops = sum(token_flops(ctx.spec, pos + 1)
                for pos in ctx.untraced_positions)
    return 100.0 * flops * ctx.batch / (ctx.untraced_s * peak)
