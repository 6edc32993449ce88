"""The witness fixpoint's steps that the witness tape ran in the host C
library, a proof: the program's `generator_tape_runs` count over its
`proofs` count, both summed over every enabled TimingTree of the process
(`utils/timing.totals()`). None where the program keeps no such count."""


def read(ctx):
    from plonky2_tpu_torch.utils import timing
    totals = getattr(timing, "totals", None)
    if totals is None:
        return None
    counts = totals()
    if not counts.get("proofs") or "generator_tape_runs" not in counts:
        return None
    return counts["generator_tape_runs"] / counts["proofs"]
