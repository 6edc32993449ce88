"""Kernels launched on the card a proof: every kernel event of the
captured call (the hand kernels and PyTorch's alike) over its proofs."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.proofs
