"""The share of the traced window in which nothing ran on the card (%):
the window (host clock) less the union of every kernel, copy and fill."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
