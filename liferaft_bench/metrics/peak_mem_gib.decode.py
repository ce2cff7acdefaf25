"""The card's peak allocated memory over set-up, the window and the batch
decoded after it, before the reference runs (GiB):
``torch.cuda.max_memory_allocated``."""


def read(ctx):
    if ctx.trace is None or not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
