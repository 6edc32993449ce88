"""The card's idle share of the captured call: 100 (1 - the union of its
device operations' intervals / the call's length)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
