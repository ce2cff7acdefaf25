"""Kernel launches a decode step: every kernel of the traced window (not
copies or fills) over its steps."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.steps or not t.kernels:
        return None
    return len(t.kernels) / ctx.steps
