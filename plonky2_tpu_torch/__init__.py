"""plonky2_tpu_torch — the PLONK + FRI prover over Goldilocks in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

The JAX package `plonky2_tpu` is the reference this port is held against,
bit for bit. The port imports neither JAX nor anything of `plonky2_tpu`: it
keeps its own copy of the host modules it needs (field reference, Poseidon
and Poseidon2 constants, witness and generators, configs, proof containers,
serialization, the host C Poseidon). Kernels are built and loaded at their
first launch, never at import (`backend.py`); the entry points run on the
GPU unless the caller asks for the CPU (`device="cpu"`).
"""
