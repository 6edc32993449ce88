"""K6's tree entry's share of its roofline over its calls in the captured
call."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx.trace, "poseidon2_merkle_tree")
