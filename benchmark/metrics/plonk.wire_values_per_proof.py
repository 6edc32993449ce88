"""The set representatives the PLONK wire matrix carries, a proof: the
program's `wire_values` count over its `proofs` count, both summed over
every enabled TimingTree of the process (`utils/timing.totals()`). None
where the program keeps no such count."""


def read(ctx):
    from plonky2_tpu_torch.utils import timing
    totals = getattr(timing, "totals", None)
    if totals is None:
        return None
    counts = totals()
    if not counts.get("proofs") or "wire_values" not in counts:
        return None
    return counts["wire_values"] / counts["proofs"]
