"""The card's peak allocated memory over the window, GiB
(`torch.cuda.max_memory_allocated` after a reset at the window's start)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
