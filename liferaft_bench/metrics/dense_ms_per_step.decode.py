"""The dense products' device time a decode step (ms): cuBLAS's GEMM and
GEMV kernels (``trace.DENSE``, neither K4 nor K5) summed over the traced
window, over its steps."""
from liferaft_bench.trace import is_dense


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.steps:
        return None
    secs = t.seconds(is_dense)
    return secs * 1e3 / ctx.steps if secs > 0 else None
