"""K7's share of its roofline over its calls in the captured call."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx.trace, "poseidon2_hash_leaves")
