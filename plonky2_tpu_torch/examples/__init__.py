"""The port's entry points, one for each of the reference's
plonky2/examples/*.rs (and the JAX package's examples/*.py):

    python -m plonky2_tpu_torch.examples.fibonacci [--device cuda|cpu]

`fibonacci`, `factorial`, `range_check`, `square_root`,
`fibonacci_serialization`, `batch_prove [B]` and `bench_recursion
[--size LOG2]`. Each builds its circuit, proves and verifies on the card
(`--device cpu` proves with the kernels' plain versions), prints what it
proved and returns it from `main(argv)`. `--seed` seeds the builder's random
stream, which fills the unused wires of a prove, so that a proof can be
reproduced. PLONKY2_TPU_TIMING=1 prints the prover's scopes;
PLONKY2_TPU_PROFILE=<dir> writes a profiler trace of the run under <dir>.
"""
