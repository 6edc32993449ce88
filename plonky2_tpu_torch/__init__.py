"""plonky2_tpu_torch — the PLONK + FRI prover over Goldilocks in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

The JAX package `plonky2_tpu` is the reference this port is held against,
bit for bit. Nothing here imports JAX; the jax-free host modules of
`plonky2_tpu` (field reference, Poseidon constants, witness and generators,
configs, proof containers, serialization, the native C Poseidon) are reused
as they are. Kernels are built and loaded at their first launch, never at
import (`backend.py`).
"""
