"""The host's waits on the card a proof: the program's `host_reads` count
over its `proofs` count, both summed over every enabled TimingTree of the
process (`utils/timing.totals()`): the traced window's calls and the
profiled call. None where the program keeps no such counts."""


def read(ctx):
    from plonky2_tpu_torch.utils import timing
    totals = getattr(timing, "totals", None)
    if totals is None:
        return None
    counts = totals()
    if not counts.get("proofs") or "host_reads" not in counts:
        return None
    return counts["host_reads"] / counts["proofs"]
