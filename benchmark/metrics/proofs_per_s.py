"""Proofs completed in the window over the time from the window's start to
the end of its last call (a batch call counts its proofs)."""


def read(ctx):
    return ctx.proofs / ctx.window_s if ctx.window_s > 0 else None
