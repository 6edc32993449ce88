#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plonky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build the CUDA kernels from plonky2_tpu_torch/csrc (one nvcc per
     source, in parallel, sm_90a);
  1a. field: csrc/field.cu, the field arithmetic (each Goldilocks and
     extension op one launch), against its plain version on the card, bit
     for bit, on random and edge values (non-canonical ones included) at
     the main path's broadcast shapes, with 0-d CUDA and CPU operands and
     strided views; each case's device ms beside its byte or operation
     bound, and the host microseconds and kernels of one op, kernel and
     plain; its records `field` and `field_ext` join the kernel table;
  2. fib100: build (seed 1234), prove and verify with the port under
     PoseidonGoldilocksConfig, and match every field of
     tests/golden/fib100_transcript.json, proof bytes included;
  3. fib100-wrap: the port builds the recursive verifier circuit of that
     proof (tests/golden_common.py's build_fib100_wrap: seed 1234,
     standard_recursion_config()), proves it cold and warm, verifies it and
     rejects a tampered proof; the cold proof's bytes and transcript go to
     chiprun_out/ (for the JAX package's verifier), and where
     tests/golden/fib100_wrap_transcript.json exists every field of it must
     be equal;
  4. fib21-poseidon2, fib21-keccak and fib21-poseidon-bn128: fib(21) under
     Poseidon2GoldilocksConfig, KeccakGoldilocksConfig and
     PoseidonBN128GoldilocksConfig against
     tests/golden/fib21_<config>_transcript.json; the last two also reject
     a flipped opening, public input and (Keccak) cap digest byte;
  5. dummy-2^14: the base proof of the reference's bench_recursion
     (dummy_circuit(standard_recursion_config(), 14, 4), public input
     0 = 42) under Poseidon: build, prove cold and twice warm, verify,
     and reject a flipped public input and a flipped opening;
  6. wrap-1 and wrap-2, the rest of bench_recursion's chain: the verifier
     circuit of the dummy-2^14 proof, then the verifier circuit of wrap-1's
     proof, each built, proved cold and twice warm, verified and
     tamper-checked, with its degree, gates, build and prove seconds (the
     warm proves' median and range), the shares of the host witness
     fixpoint and of round 3 (the quotient; the prover's TimingTree scopes
     "run generators" and "compute quotient polys", synchronized), and the
     peak device memory (phases 3, 5 and 6a-9 log the same);
  6a. outer-keccak: the fib100-wrap of phase 3 built under
     KeccakGoldilocksConfig, proved cold and once warm, and wrap-2 under
     Keccak (the verifier of wrap-1's Poseidon proof) built and proved once;
     outer-poseidon-bn128: the fib100-wrap under
     PoseidonBN128GoldilocksConfig, built and proved once, after timing
     BN128 permutations with one thread and with every core. Each is
     verified and tamper-checked; the seconds of the host hashing (the
     trees, the PoW grind) in the build and each prove are logged apart;
     only K1 and the field kernels may launch (the commits hash on the
     host); the fib100-wraps'
     proof bytes go to chiprun_out/ (for the JAX package's verifier, run
     with `--gc`);
  7. cyclic-ivc: the reference's test_cyclic_recursion at
     standard_recursion_config(): the goal CommonCircuitData of degree 2^13
     (recursion/cyclic.py common_data_for_recursion, host layout), the
     hash-chain circuit built on it (a dummy proof for the goal is proved
     inside the build), the base proof (a dummy proof carrying the
     circuit's verifier data), then three steps, each verifying the proof
     before it: every step verified, its embedded verifier data checked,
     its counter 1, 2, 3 and its latest hash equal to the host Poseidon
     iterated from [0, 1, 2, 3]; a flipped opening and public input, and a
     changed embedded verifier key (step 2, and the base proof, which the
     witness fixpoint refuses), rejected;
  8. conditional: tests/test_conditional.py's circuit: fib(100) and fib(99)
     proved, the outer circuit verifying one of them by a boolean built,
     proved with condition 1 and 0, both verified and tampered;
  9. dummy-2^14-poseidon2: phase 5 under Poseidon2;
  9a. schnorr-ecgfp5: the reference's in-circuit Schnorr verification over
     EcGFp5 (tests/gadget_circuits.py `schnorr`: tests/test_schnorr_circuit.py's
     signed message from random.Random(97), standard_recursion_config(),
     seed 1234; 2^12, 13 gate types) built, proved cold and twice warm,
     verified and tampered, its cold proof's bytes to chiprun_out/,
     each gate type's evaluation over round 3's grid timed beside round 3
     (9b too); the same circuit over a signature with s + 1 must make no
     witness;
  9b. secp256k1-curve: tests/test_curve_gadgets.py's add/double circuit
     (standard_ecc_config(), 136 wires, 2^10, all five u32 gates) proved
     cold and once warm, verified, tampered, add, double and neg in its
     witness equal to the native curve's, its bytes to chiprun_out/;
  9c. lookups: tests/test_lookup.py's test_two_luts circuit proved once,
     verified, tampered, its public inputs the test's, its bytes to
     chiprun_out/ (scripts/jax_verify_gadget_proofs.py verifies the three
     with the JAX package);
  9d. gates on the card: round 3's evaluation of every new gate the
     gadget phases laid out (the u32 gates, MulGFp5Gate, LookupGate) and of
     LookupTableGate, both interpolation gates and PoseidonMdsGate over
     2^13 random rows on the card, bit-equal to the CPU;
  9e. starky (tests/stark_circuits.py; StarkConfig.standard_fast_config():
     rate 1, 84 queries, PoW 16 bits): starky-fib, the reference's
     FibonacciStark at 2^20 rows (cold and three times warm, a result + 1
     rejected); starky-wide, 64 Fibonacci lanes (128 columns) over 2^20
     rows (cold and twice warm); starky-logup, PermutationStark at 2^20
     (cold and once warm, a trace that is no permutation rejected);
     starky-ctl, tests/test_ctl.py's two tables at 2^20 rows through
     prove_multi and verify_multi (cold and once warm, a multiset mismatch
     rejected); starky-recursive, the starky-fib proof verified inside a
     plonky2 circuit (2^14) built, proved cold and three times warm,
     verified and tampered, its public inputs the STARK's, and a STARK
     proof with a flipped FRI opening refused by the witness fixpoint;
     starky-poseidon2, FibonacciStark at 2^16 under Poseidon2, proved once.
     Each logs its proves by TimingTree scope, its peak memory and
     launches; each verifies every proof and rejects a flipped opening;
  9f. batch-dummy-2^14: the dummy-2^14 circuit of phase 5 proved by
     plonk/batch_prover.py prove_batch for 4 distinct witnesses (public
     input 0 = 42 + i), cold and warm, then the same witnesses through
     serial prove, then a batch of 3; the builder's random stream is rewound
     before each, and every batched proof must equal its serial twin byte
     for byte; all verify, one is tampered; seconds, hand-kernel launches
     and aten ops a proof and peak memory, batched and serial;
  9f'. scopes: dummy-2^14 proved warm by default and under an enabled
     TimingTree (seconds, equal hand-kernel launches);
     then one timed warm prove of dummy-2^14 and of the fib100-wrap and a
     timed B = 4 batch of the dummy: each scope's seconds and share of the
     prove, the labels those of the JAX package in its order;
  9g. batch-dummy-2^14-poseidon2: the same at B = 2 under Poseidon2;
  9h. zk-fib: fib(31) under standard_recursion_zk_config(), which blinding
     lays out at 2^14: proved cold and warm with unseeded salts (both
     verify, their wires caps differ), twice with one seeded salt stream
     and the builder's stream rewound (equal bytes), tampered; its bytes to
     chiprun_out/zk_fib_proof.bin;
  9i. compressed: the dummy-2^14 proof and the zk-fib proof compressed,
     serialized, read back, decompressed to their original bytes and
     verified by verify_compressed; a tampered compressed proof refused;
     the dummy's compressed bytes to chiprun_out/dummy_2_14_compressed.bin
     (scripts/jax_verify_service_proofs.py verifies both files with the JAX
     package);
  9j. circuit-serialization: a dummy-2^14 CircuitData saved and loaded on
     the card (its constants recommitted through K1, K3 and K2): the loaded
     prover, handed the original's random stream, proves the original's
     bytes, and the verifier data read from its own blob verifies them;
  9k. mesh-prove: on a one-rank NCCL process group (tcp on a free
     127.0.0.1 port, destroyed after the phase; NCCL takes one rank a
     card, so the collectives between ranks are tested on CPU ranks), the
     dummy-2^14 circuit of phase 5 and the starky-fib system proved twice
     serially and twice under prover_mesh(make_mesh()), every proof equal
     (the builder's random stream rewound before each PLONK prove),
     seconds and peak memory of both ways; commit_sharded_2d of [135, 2^14]
     at rate 3 and cap 4 on a (1, 1) mesh equal to commit_batch;
  9l. four-step-lde: parallel/ntt_sharded.py coset_lde_large of one
     polynomial of 2^24 coefficients at rate 3 (2^27 points, past K1's
     2^24) on a one-rank mesh, cold and warm, equal at 64 seeded points to
     direct evaluation on the card, each step timed; 2^21 -> 2^24 equal to
     K1's direct coset LDE and to forward_plain over its whole output;
  9m. merkle-update: a 2^17-leaf tree of 135-element leaves at cap 4
     updated in place (one leaf, then 200 across a subtree boundary),
     every layer equal to a rebuild, update and rebuild ms;
  9n. context and circom, on the host: the fib100-wrap builder's gate
     report, and the exported vanishing verifier (circom) evaluated on
     the fib100 proof: accepted, a tampered opening rejected;
  9o. examples: the seven entry points of plonky2_tpu_torch/examples
     (`main(argv)`, the card, default sizes, --seed 1234), each printing the
     JAX example's values and launching K1-K3: fibonacci against
     tests/golden/fib100_transcript.json, factorial, range_check and
     square_root against the JAX package's proof bytes
     (tests/golden/example_<name>.bin), fibonacci_serialization's reloaded
     circuit proving the original's bytes, batch_prove's four proofs equal
     to serial proves, bench_recursion's 2^12 dummy proof and its wrap
     verified;
  9p. profile: the fibonacci example under PLONKY2_TPU_PROFILE=<temp dir>:
     its Chrome trace names the prover's eight scopes and holds events of
     K1's, K2's (both entries) and K3's CUDA functions; the card's busy
     share inside the prove's scopes;
  10. every other kernel (phase 1a holds the field records) against its
     plain PyTorch version on the card, at every
     shape phases 3, 5-9, 9a-9c, 9e-9h, 9j-9m and 9o launched it at, and K7 at
     zk-fib's salted leaf widths as well (tolerance:
     bit-exact), over full outputs, except where the plain version would
     take tens of seconds: K1 above 2^25 output elements on a seeded sample
     of its rows, a tree above 2^17 leaves on each of its subtrees of 2^17
     leaves where it has at most four (a batch's trees) and otherwise on
     one seeded subtree, a leaf hash above 2^25 elements on 2^16 seeded
     leaves; with
     its device time, its wrapper's time, the plain version's time, its
     bound and its device ms per warm prove;
  11. K1 past 2^19: coset LDE [1, 2^17 -> 2^20] and [1, 2^21 -> 2^24] at
     rate 3, inverse [2, 2^20] with and without a shift and [1, 2^24],
     against the plain version over full outputs, with device ms and
     launches a call;
  12. edge batches: K2 and K6 (both entries each), K3 and K7 against their
     plain versions on states and leaves made of 0, 1, 2^32 - 1, 2^32,
     p - 1 = 2^64 - 2^32 and the non-canonical p, p + 1 and 2^64 - 1, mixed
     with random ones, on states of all 2^64 - 1, and on leaves of p - 1;
     K1's forward (2^14, with and without a shift, 2^14 -> 2^17, 2^17 ->
     2^20 and 2^20 -> 2^23) and inverse (2^14, 2^17 and 2^20) on canonical
     rows of 0, 1, p - 1, 2^32 - 1 and 2^32 mixed with random values, and on
     rows of all p - 1 (bit-exact; rows past 2^19 points pass values left
     unreduced from one column round to the next);
  13. PoW stress: the full output of one 2^19-state wave of K2 and of K6
     against the host C permutation, then waves from the fib100 and
     fib21-poseidon2 transcript states through both hashers and from random
     sponge states (48 through K2, 24 through K6), each witness checked on
     the host to meet the bound, and for the transcript states and 8 random
     ones of each hasher to be the smallest that does.
The kernel counts are set to 0 just before each of phases 3, 5-9, 9a-9c,
9e-9h, 9j-9m and 9o (6a's three drives included) and
read just after it; a kernel of a phase's path (the field records on every
one) that it never launched fails the phase. The line before the last is
the kernel table as JSON; the last line is {"ok": true, "device": {...}}.
Exits non-zero without a GPU, and imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None          # the port must not need JAX
sys.modules["plonky2_tpu"] = None  # nor the JAX package

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100's HBM bandwidth, SMs, IMAD rate a SM and clock, and IMADs a field
# multiply (at least four 32-bit partial products)
from benchmark.roofline.peaks import (  # noqa: E402
    HBM_BYTES_PER_S, IMAD_PER_FIELD_MUL, IMAD_PER_SM_CLOCK, SMS,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
P2 = "Poseidon2GoldilocksConfig"
KECCAK_GC = "KeccakGoldilocksConfig"
BN128_GC = "PoseidonBN128GoldilocksConfig"
# the kernels of a path under each hasher config: the field arithmetic's
# (csrc/field.cu) on every one; only K1 besides under a host hasher
FIELD_KERNELS = ("field", "field_ext")
POSEIDON_PATH = ("ntt", "poseidon_permute", "poseidon_merkle_tree",
                 "poseidon_hash_leaves") + FIELD_KERNELS
POSEIDON2_PATH = ("ntt", "poseidon2_permute", "poseidon2_merkle_tree",
                  "poseidon2_hash_leaves") + FIELD_KERNELS
HOST_HASH_PATH = ("ntt",) + FIELD_KERNELS

P = (1 << 64) - (1 << 32) + 1      # the Goldilocks prime
# general (full 64-bit) field multiplies per permutation, from the
# algorithm. Poseidon: the x^7 S-boxes, 4 multiplies each, of 8 full rounds
# x 12 and 22 partial rounds x 1; its MDS constants are below 2^6 (shifts
# and adds), so it has no other. Poseidon2: the same S-boxes in 8 full
# rounds x 12 and 22 internal rounds x 1, plus the 22 x 12 products by the
# full 64-bit internal diagonal
FIELD_MULS = {"poseidon_permute": (8 * 12 + 22) * 4,
              "poseidon2_permute": (8 * 12 + 22) * 4 + 22 * 12}
# warm proves of each main-path phase, after its cold one (the PLONK
# phases; starky-fib and starky-recursive take STARK_WARM_PROVES)
WARM_PROVES = 2
STARK_WARM_PROVES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator: run, time and report one phase."""
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            log(f"[{name}] ok in {time.perf_counter() - t0:.3f} s")
            return out
        return run
    return wrap


def _fib(steps: int, gc, device):
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(steps):
        prev, cur = cur, builder.add(prev, cur)
    for t in (a, b, cur):
        builder.register_public_input(t)
    data = builder.build(device=device, gc=gc)
    pw = PartialWitness()
    pw.set_target(a, 0)
    pw.set_target(b, 1)
    proof = data.prove(pw)
    data.verify(proof)
    return data, proof


def _transcript(data, proof) -> dict:
    """The 13 fields of a golden transcript file."""
    from plonky2_tpu_torch.plonk.get_challenges import get_challenges
    from plonky2_tpu_torch.utils.serialization import (
        serialize_proof_with_pis,
    )

    common = data.common
    pi_hash = common.gc.hash_public_inputs(proof.public_inputs)
    ch = get_challenges(proof, pi_hash, data.verifier_only.circuit_digest,
                        common)
    fc = ch.fri_challenges
    return {
        "circuit_digest": list(data.verifier_only.circuit_digest),
        "public_inputs": list(proof.public_inputs),
        "pi_hash": list(pi_hash),
        "betas": list(ch.plonk_betas), "gammas": list(ch.plonk_gammas),
        "alphas": list(ch.plonk_alphas), "zeta": list(ch.plonk_zeta),
        "fri_alpha": list(fc.fri_alpha),
        "fri_betas": [list(x) for x in fc.fri_betas],
        "fri_pow_response": fc.fri_pow_response,
        "fri_query_indices": list(fc.fri_query_indices),
        "pow_witness": proof.proof.opening_proof.pow_witness,
        "proof_hex": serialize_proof_with_pis(proof, common).hex(),
    }


def _golden(name: str, data, proof, path: str) -> None:
    got = _transcript(data, proof)
    with open(path) as f:
        want = json.load(f)
    bad = [k for k in want if got[k] != want[k]]
    if bad or len(want) != 13:
        raise AssertionError(f"{name} transcript fields diverged: {bad}")
    log(f"{name}: all {len(want)} golden transcript fields equal "
        f"(proof {len(got['proof_hex']) // 2} bytes)")


POW_STATES = []   # (hasher, state, witness_pos, pow_bits) of the fib proofs


def _recording_pow_waves(hasher):
    """Wraps the prover's PoW wave to record its inputs under `hasher`."""
    from plonky2_tpu_torch.fri import prover

    wave = prover._pow_wave

    def recorded(permute, state, witness_pos, pow_bits, batch, device):
        POW_STATES.append((hasher, list(state), witness_pos, pow_bits))
        return wave(permute, state, witness_pos, pow_bits, batch, device)
    prover._pow_wave = recorded
    return wave


@phase("fib100")
def fib100(device):
    from plonky2_tpu_torch.fri import prover
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    wave = _recording_pow_waves(PoseidonGoldilocksConfig.hasher)
    try:
        data, proof = _fib(99, PoseidonGoldilocksConfig, device)
    finally:
        prover._pow_wave = wave
    _golden("fib100", data, proof,
            os.path.join(GOLDEN_DIR, "fib100_transcript.json"))
    return data, proof


@phase("fib21-poseidon2")
def fib21_poseidon2(device):
    from plonky2_tpu_torch.fri import prover
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    wave = _recording_pow_waves(CONFIGS[P2].hasher)
    try:
        data, proof = _fib(20, CONFIGS[P2], device)
    finally:
        prover._pow_wave = wave
    _golden("fib21-poseidon2", data, proof,
            os.path.join(GOLDEN_DIR, f"fib21_{P2}_transcript.json"))


def _tampered(proof):
    """Copies of a proof with one value flipped: the first opening of the
    wires, the first public input where there is one, and under a
    byte-digest hasher (Keccak) the first byte of the wires cap's first
    digest."""
    bad = copy.deepcopy(proof)
    w = bad.proof.openings.wires
    w[0] = ((w[0][0] + 1) % P, w[0][1])
    out = [("flipped opening", bad)]
    if proof.public_inputs:
        bad = copy.deepcopy(proof)
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
        out.append(("flipped public input", bad))
    digest = proof.proof.wires_cap[0]
    if isinstance(digest, bytes):
        bad = copy.deepcopy(proof)
        bad.proof.wires_cap[0] = bytes([digest[0] ^ 1]) + digest[1:]
        out.append(("flipped byte of a Keccak cap digest", bad))
    return out


def _reject_tampered(name: str, data, proof) -> None:
    for what, bad in _tampered(proof):
        try:
            data.verify(bad)
        except AssertionError as e:
            log(f"{name}: {what} rejected ({e})")
        else:
            raise AssertionError(f"{name}: a proof with a {what} verified")


def _require_bn128_library() -> None:
    """The BN128 phases run the threaded C library of host.py, never its
    Python fallback (hours at the wrap's size)."""
    from plonky2_tpu_torch import host
    if host.load_bn128() is None:
        raise AssertionError("the PoseidonBN128 C library did not build")


def _fib21_outer(name: str, gc_name: str, device) -> None:
    """fib(21) under an outer-proof config against its golden transcript,
    and tampered copies rejected."""
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    data, proof = _fib(20, CONFIGS[gc_name], device)
    _golden(name, data, proof,
            os.path.join(GOLDEN_DIR, f"fib21_{gc_name}_transcript.json"))
    _reject_tampered(name, data, proof)


@phase("fib21-keccak")
def fib21_keccak(device):
    _fib21_outer("fib21-keccak", KECCAK_GC, device)


@phase("fib21-poseidon-bn128")
def fib21_poseidon_bn128(device):
    _require_bn128_library()
    _fib21_outer("fib21-poseidon-bn128", BN128_GC, device)


def _leaf_permutations(h, leaves) -> int:
    n, width = leaves.shape
    if width * 8 <= h.hash_size:
        return 0
    if h.algebraic:
        return n * math.ceil(width / 8)       # rate 8 elements
    return n * (width * 8 // 136 + 1)         # rate 136 bytes, 0x01 pad


# a host hasher's batches: the permutations a call makes (keccak-f[1600]
# under Keccak: one a 136-byte block; three for the challenger's onion)
HOST_BATCHES = {
    "hash_leaves_np": _leaf_permutations,
    "compress_np": lambda h, left, right: left.shape[0],
    "permute_many_host": lambda h, states: (
        states.shape[0] * (1 if h.algebraic else 3)),
}


@contextlib.contextmanager
def _host_hashing(seconds: dict):
    """Adds the seconds and the permutations (`HOST_BATCHES`) of the host
    hashers' batches to `seconds`."""
    from plonky2_tpu_torch.hash.hashers import KECCAK, POSEIDON_BN128

    def timed(hasher, name, fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            seconds["seconds"] += time.perf_counter() - t
            seconds["permutations"] += HOST_BATCHES[name](hasher, *args)
            return out
        return run
    for hasher in (KECCAK, POSEIDON_BN128):
        for name in HOST_BATCHES:
            setattr(hasher, name, timed(hasher, name, getattr(hasher, name)))
    try:
        yield
    finally:
        for hasher in (KECCAK, POSEIDON_BN128):
            for name in HOST_BATCHES:
                delattr(hasher, name)


STEP_SECONDS = {}  # drive name -> the step seconds of each of its proves


def _drive(name: str, device, build, kernels: tuple,
           proves: int = 1 + WARM_PROVES):
    """Build one circuit, prove it `proves` times (a cold prove, then warm
    ones), verify every proof and tamper-check the first; the counts are set
    to 0 just before and read just after. `build()` returns the circuit's
    data and `inputs(proofs)`, the witness of the next prove given the
    proofs made so far. Under a host hasher (Keccak, PoseidonBN128) the
    seconds of its host batches in the build and in each prove are logged
    apart (`_host_hashing`), and no Poseidon or Poseidon2 kernel may launch.
    Returns ((launches, shapes, warm shapes), data, proofs): {kernel:
    launches}, {kernel: {shape: launches}} and the last prove's {kernel:
    {shape: launches}}."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.utils.timing import TimingTree

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    backend.reset_counts()
    host_s = {"seconds": 0.0, "permutations": 0}
    marks = []  # host_s after the build and after each prove

    def steps(timing) -> dict:
        """Two of the prover's TimingTree scopes, each ending in a
        synchronize: the host witness fixpoint and round 3 (the quotient:
        every gate constraint over the LDE grid)."""
        seconds = timing.seconds()
        return {"witness fixpoint": seconds["run generators"],
                "round 3": seconds["compute quotient polys"]}
    with _host_hashing(host_s):
        t0 = time.perf_counter()
        data, inputs = build()
        torch.cuda.synchronize(device)
        t_build = time.perf_counter() - t0
        marks.append(dict(host_s))
        times, proofs, step_s = [], [], []
        for _ in range(proves):
            before = {k.name: dict(k.shapes)
                      for k in backend.KERNELS.values()}
            pw = inputs(proofs)
            timing = TimingTree(name, enabled=True)
            t0 = time.perf_counter()
            proofs.append(data.prove(pw, timing))
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            step_s.append(steps(timing))
            marks.append(dict(host_s))

    STEP_SECONDS[name] = step_s
    warm = {k.name: {s: n - before[k.name].get(s, 0)
                     for s, n in k.shapes.items()
                     if n > before[k.name].get(s, 0)}
            for k in backend.KERNELS.values()}
    t0 = time.perf_counter()
    for proof in proofs:
        data.verify(proof)
    t_verify = (time.perf_counter() - t0) / len(proofs)
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated(device)

    _reject_tampered(name, data, proofs[0])

    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched by the main "
                             f"path: {missing}")
    common = data.common
    hasher = common.gc.hasher
    hashed = [k for k in launches if k not in HOST_HASH_PATH and launches[k]]
    if not hasher.device and hashed:
        raise AssertionError(f"{name}: {hasher.name} hashes on the host, "
                             f"yet {hashed} launched")
    cold = "; ".join(f"{what} {s:.3f} s, {s / times[0]:.1%}"
                     for what, s in step_s[0].items())

    def spread(values, fmt):
        return (f"median {fmt(statistics.median(values))} "
                f"({fmt(min(values))}-{fmt(max(values))})")
    if proves > 1:
        shares = {what: [s[what] / t for s, t in zip(step_s[1:], times[1:])]
                  for what in step_s[0]}
        warm_s = "; ".join(f"{what} {spread(v, '{:.1%}'.format)}"
                           for what, v in shares.items())
        warm_s = (f"warm x{proves - 1} "
                  f"{spread(times[1:], '{:.3f} s'.format)} ({warm_s})")
    else:
        warm_s = "no warm prove"
    log(f"{name}: {common.gc.name}, degree 2^{common.degree_bits}, FRI "
        f"arities {common.fri_params.reduction_arity_bits}, build "
        f"{t_build:.3f} s, prove cold {times[0]:.3f} s ({cold}), {warm_s}, "
        f"verify {t_verify:.3f} s, peak allocated {peak / 2**20:.1f} MiB")
    if proves > 1:
        log(f"{name}: warm proves {[round(t, 3) for t in times[1:]]} s, "
            f"steps {[{k: round(v, 3) for k, v in s.items()} for s in step_s[1:]]}")
    if not hasher.device:
        deltas = [(b["seconds"] - a["seconds"],
                   b["permutations"] - a["permutations"])
                  for a, b in zip([{"seconds": 0.0, "permutations": 0}]
                                  + marks, marks)]
        log(f"{name}: host {hasher.name} hashing ({os.cpu_count()} host "
            f"cores): build {deltas[0][0]:.3f} s, proves "
            f"{[round(d[0], 3) for d in deltas[1:]]} s; "
            + ("permutations" if hasher.algebraic else "keccak-f[1600] calls")
            + f" (build, proves) {[d[1] for d in deltas]}")
    log(f"{name}: gates {[g.id() for g in common.gates]}")
    log(f"{name}: launches {launches}")
    for k, prefix in (("K2", "poseidon"), ("K6", "poseidon2")):
        log(f"{name}: {k} launches (permute + merkle_tree) "
            f"{launches[prefix + '_permute'] + launches[prefix + '_merkle_tree']}")
    return (launches, shapes, warm), data, proofs


def _dummy_build(gc, device):
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.recursion.dummy import dummy_circuit, dummy_witness

    def build():
        data, pis = dummy_circuit(CircuitConfig.standard_recursion_config(),
                                  14, 4, device=device, gc=gc)
        return data, lambda proofs: dummy_witness(pis, {0: 42})
    return build


def _wrap_build(inner, proof, device, gc=None):
    """The recursive verifier circuit of `proof` (recursion/verifier.py
    wrap_circuit: seed 1234, standard_recursion_config()), committed under
    `gc` (default Poseidon)."""
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    from plonky2_tpu_torch.recursion.verifier import wrap_circuit

    def build():
        builder, witness = wrap_circuit(inner)
        data = builder.build(device=device,
                             gc=gc or PoseidonGoldilocksConfig)
        return data, lambda proofs: witness(proof)
    return build


def _write_proof(file_name: str, data, proof) -> None:
    from plonky2_tpu_torch.utils.serialization import (
        serialize_proof_with_pis,
    )
    os.makedirs(OUT_DIR, exist_ok=True)
    raw = serialize_proof_with_pis(proof, data.common)
    with open(os.path.join(OUT_DIR, file_name), "wb") as f:
        f.write(raw)
    log(f"{len(raw)} proof bytes written to chiprun_out/{file_name}")


@phase("fib100-wrap")
def fib100_wrap(device, fib):
    """Returns the drive's counts, the wrap's data and its witness
    function."""
    made = {}

    def build():
        made["data"], made["inputs"] = _wrap_build(*fib, device)()
        return made["data"], made["inputs"]
    run, data, (proof, *_) = _drive("fib100-wrap", device, build,
                                    POSEIDON_PATH)
    _write_proof("fib100_wrap_proof.bin", data, proof)
    with open(os.path.join(OUT_DIR, "fib100_wrap_transcript.json"), "w") as f:
        json.dump(_transcript(data, proof), f, indent=1)
    golden = os.path.join(GOLDEN_DIR, "fib100_wrap_transcript.json")
    if os.path.exists(golden):
        _golden("fib100-wrap", data, proof, golden)
    else:
        log("fib100-wrap: no golden file; proof bytes and transcript "
            "written to chiprun_out/")
    return run, data, made["inputs"]


@phase("dummy-2^14")
def dummy_2_14(device):
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    return _drive("dummy-2^14", device,
                  _dummy_build(PoseidonGoldilocksConfig, device),
                  POSEIDON_PATH)


@phase("wrap-1")
def wrap_1(device, inner, proof):
    return _drive("wrap-1", device, _wrap_build(inner, proof, device),
                  POSEIDON_PATH)


@phase("wrap-2")
def wrap_2(device, inner, proof):
    return _drive("wrap-2", device, _wrap_build(inner, proof, device),
                  POSEIDON_PATH)


@phase("outer-keccak")
def outer_keccak(device, fib, wrap):
    """The fib100-wrap committed under KeccakGoldilocksConfig (the outer
    proof of a chain, for an EVM verifier), proved cold and once warm; then
    wrap-2 under Keccak, the verifier of wrap-1's Poseidon proof, proved
    once. Only K1 and the field arithmetic run on the card; the trees, the
    challenger and the PoW hash on the host."""
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    gc = CONFIGS[KECCAK_GC]
    run, data, (proof, *_) = _drive("outer-keccak fib100-wrap", device,
                                    _wrap_build(*fib, device, gc), HOST_HASH_PATH,
                                    proves=2)
    _write_proof("fib100_wrap_keccak_proof.bin", data, proof)
    run2 = _drive("outer-keccak wrap-2", device,
                  _wrap_build(*wrap, device, gc), HOST_HASH_PATH,
                  proves=1)[0]
    return run, run2


# BN128 permutations timed alone, with one thread and with every core
BN128_PROBE_STATES = 4096


@phase("outer-poseidon-bn128")
def outer_poseidon_bn128(device, fib):
    """The fib100-wrap committed under PoseidonBN128GoldilocksConfig (the
    outer proof for a BN254 circom verifier), built and proved once; its
    trees and PoW run in the threaded C library of host.py."""
    from plonky2_tpu_torch import host
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    _require_bn128_library()
    rng = np.random.default_rng(128)
    states = rng.integers(0, P, size=(BN128_PROBE_STATES, 12),
                          dtype=np.uint64)
    per_perm = {}
    for threads in (1, os.cpu_count()):
        t0 = time.perf_counter()
        host.bn128_permute_many(states, threads)
        per_perm[threads] = (time.perf_counter() - t0) / len(states)
    log(f"outer-poseidon-bn128: host os.cpu_count() {os.cpu_count()}; "
        f"{len(states)} BN128 permutations at "
        + ", ".join(f"{t} thread(s) {s * 1e6:.1f} us"
                    for t, s in per_perm.items())
        + f" each; the batches use {os.cpu_count()} threads")
    run, data, (proof, *_) = _drive(
        "outer-poseidon-bn128 fib100-wrap", device,
        _wrap_build(*fib, device, CONFIGS[BN128_GC]), HOST_HASH_PATH,
        proves=1)
    _write_proof("fib100_wrap_bn128_proof.bin", data, proof)
    return run


# the degree of the cyclic circuit's goal CommonCircuitData at
# standard_recursion_config(): the smallest at which the hash-chain circuit
# fits (the verifier of a verifier of an empty circuit already needs 2^13)
CYCLIC_DEGREE_BITS = 13
CYCLIC_STEPS = 3
INITIAL_HASH = [0, 1, 2, 3]


def _hash_chain(common, device, seconds: dict):
    """The reference's test_cyclic_recursion circuit: public inputs
    [initial hash (4), latest hash (4), counter, the circuit's own verifier
    data]; a step hashes the inner proof's latest hash (condition 1) or the
    initial hash (condition 0, the base step, whose inner proof is a dummy)
    and adds one to the inner counter. Sets `common.num_public_inputs`, as
    the reference does. Returns (builder, inputs(condition, inner proof,
    verifier data) -> PartialWitness); `seconds` gets the dummy circuit's
    build and the dummy prove (with the verifier's layout) made inside."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.recursion.cyclic import (
        conditionally_verify_cyclic_proof_or_dummy,
    )
    from plonky2_tpu_torch.recursion.dummy import dummy_circuit_for_common
    from plonky2_tpu_torch.recursion.targets import (
        add_virtual_proof_with_pis, set_proof_with_pis_target,
        set_verifier_data_target,
    )

    builder = CircuitBuilder(common.config, seed=1234)
    one = builder.one()
    initial_hash = builder.add_virtual_targets(4)
    builder.register_public_inputs(initial_hash)
    current_hash_in = builder.add_virtual_targets(4)
    builder.register_public_inputs(
        builder.hash_n_to_hash_no_pad(list(current_hash_in)))
    counter = builder.add_virtual_target()
    builder.register_public_input(counter)
    verifier_data = builder.add_verifier_data_public_inputs()
    common.num_public_inputs = len(builder.public_inputs)

    condition = builder.add_virtual_target()
    builder.assert_bool(condition)
    inner = add_virtual_proof_with_pis(builder, common)
    inner_pis = inner.public_inputs
    for t, u in zip(initial_hash, inner_pis[0:4]):
        builder.connect(t, u)
    for t, a, b in zip(current_hash_in, inner_pis[4:8], initial_hash):
        builder.connect(t, builder.select(condition, a, b))
    builder.connect(counter, builder.mul_add(condition, inner_pis[8], one))

    t0 = time.perf_counter()
    dummy_circuit_for_common(common, device=device)
    torch.cuda.synchronize(device)
    seconds["dummy build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    conditionally_verify_cyclic_proof_or_dummy(builder, condition, inner,
                                               common, device=device)
    torch.cuda.synchronize(device)
    seconds["dummy prove + verifier layout"] = time.perf_counter() - t0

    def inputs(condition_value, inner_proof, verifier_only):
        pw = PartialWitness()
        pw.set_target(condition, condition_value)
        set_proof_with_pis_target(pw, inner, inner_proof)
        set_verifier_data_target(pw, verifier_data, verifier_only)
        return pw
    return builder, inputs


@phase("cyclic-ivc")
def cyclic_ivc(device):
    """The reference's test_cyclic_recursion at standard_recursion_config():
    the hash-chain circuit verifies, at each step, a proof of itself (at
    the base step, a dummy proof); CYCLIC_STEPS steps proved, verified and
    checked against the host Poseidon, then tampered."""
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.recursion.cyclic import (
        check_cyclic_proof_verifier_data, common_data_for_recursion,
    )
    from plonky2_tpu_torch.recursion.dummy import cyclic_base_proof

    t0 = time.perf_counter()
    common = common_data_for_recursion(
        CircuitConfig.standard_recursion_config(), CYCLIC_DEGREE_BITS)
    t_goal = time.perf_counter() - t0
    seconds, made = {}, {}

    def build():
        t0 = time.perf_counter()
        builder, made["inputs"] = _hash_chain(common, device, seconds)
        t1 = time.perf_counter()
        data = builder.build(device=device)
        torch.cuda.synchronize(device)
        seconds["layout"] = t1 - t0
        seconds["build_host + commit"] = time.perf_counter() - t1
        if not data.common.same_shape(common):
            raise AssertionError("cyclic-ivc: the circuit's CommonCircuitData "
                                 "is not the goal's")

        def step_inputs(proofs):
            if proofs:
                return made["inputs"](1, proofs[-1], data.verifier_only)
            t = time.perf_counter()
            made["base"] = cyclic_base_proof(
                common, data.verifier_only, dict(enumerate(INITIAL_HASH)),
                device=device)
            torch.cuda.synchronize(device)
            seconds["base proof"] = time.perf_counter() - t
            check_cyclic_proof_verifier_data(made["base"], data.verifier_only,
                                             common)
            return made["inputs"](0, made["base"], data.verifier_only)
        return data, step_inputs

    run, data, proofs = _drive("cyclic-ivc", device, build, POSEIDON_PATH,
                               proves=CYCLIC_STEPS)
    latest = list(INITIAL_HASH)
    for k, proof in enumerate(proofs, 1):
        check_cyclic_proof_verifier_data(proof, data.verifier_only,
                                         data.common)
        latest = list(POSEIDON.hash_no_pad_oracle(latest))
        pis = proof.public_inputs
        if pis[0:4] != INITIAL_HASH or pis[4:8] != latest or pis[8] != k:
            raise AssertionError(f"cyclic-ivc: step {k} public inputs "
                                 f"{pis[:9]}, want {INITIAL_HASH}, {latest}, "
                                 f"{k}")
    log(f"cyclic-ivc: {len(proofs)} steps verified, their verifier data "
        f"checked, counters {[p.public_inputs[8] for p in proofs]}, latest "
        f"hash {latest} equal to the host Poseidon's")

    # one element of the embedded verifier data changed: in the step-2
    # proof, and in the base proof, whose copy constraints the witness
    # fixpoint then cannot meet (before any device work)
    vk_start = common.num_public_inputs - 4 - 4 * \
        common.config.fri_config.num_cap_elements
    bad_step, bad_base = copy.deepcopy(proofs[1]), copy.deepcopy(made["base"])
    for bad in (bad_step, bad_base):
        bad.public_inputs[vk_start] = (bad.public_inputs[vk_start] + 1) % P
    checks = [("check_cyclic_proof_verifier_data", "",
               lambda: check_cyclic_proof_verifier_data(
                   bad_step, data.verifier_only, data.common)),
              ("verify", "", lambda: data.verify(bad_step)),
              ("the base step's witness fixpoint", "set twice",
               lambda: data.prove(made["inputs"](0, bad_base,
                                                 data.verifier_only)))]
    for what, message, check in checks:
        try:
            check()
        except AssertionError as e:
            if message not in str(e):
                raise
            log(f"cyclic-ivc: a changed embedded verifier key rejected by "
                f"{what} ({str(e)[:160]})")
        else:
            raise AssertionError(f"cyclic-ivc: {what} accepted a changed "
                                 f"embedded verifier key")
    log(f"cyclic-ivc: goal CommonCircuitData (host layout) {t_goal:.3f} s; "
        f"build parts {({k: round(v, 3) for k, v in seconds.items()})} s")
    for name in POSEIDON_PATH:
        if name not in FIELD_KERNELS:
            log(f"cyclic-ivc: {name} launches by shape {run[1][name]}")
    return run


@phase("conditional")
def conditional(device):
    """tests/test_conditional.py's circuit on the card: fib(100) and fib(99)
    proved (two circuits of one shape), the outer circuit that verifies the
    first where its condition is 1 and the second where it is 0, proved
    with condition 1 and then 0, both verified and tampered."""
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.recursion.conditional import (
        conditionally_verify_proof,
    )
    from plonky2_tpu_torch.recursion.targets import (
        add_virtual_proof_with_pis, add_virtual_verifier_data,
        set_proof_with_pis_target, set_verifier_data_target,
    )

    inner = [_fib(steps, PoseidonGoldilocksConfig, device)
             for steps in (99, 98)]
    (data0, proof0), (data1, proof1) = inner
    if not data0.common.same_shape(data1.common):
        raise AssertionError("conditional: fib(100) and fib(99) differ in "
                             "shape")
    if data0.verifier_only.circuit_digest == data1.verifier_only.circuit_digest:
        raise AssertionError("conditional: the two inner circuits are one")

    def build():
        config = CircuitConfig.standard_recursion_config()
        builder = CircuitBuilder(config, seed=1234)
        condition = builder.add_virtual_target()
        builder.assert_bool(condition)
        pts = [add_virtual_proof_with_pis(builder, data0.common)
               for _ in inner]
        vts = [add_virtual_verifier_data(builder,
                                         config.fri_config.cap_height)
               for _ in inner]
        conditionally_verify_proof(builder, condition, pts[0], vts[0],
                                   pts[1], vts[1], data0.common)
        data = builder.build(device=device)

        def inputs(proofs):
            pw = PartialWitness()
            pw.set_target(condition, 0 if proofs else 1)
            for pt, vt, (d, p) in zip(pts, vts, inner):
                set_proof_with_pis_target(pw, pt, p)
                set_verifier_data_target(pw, vt, d.verifier_only)
            return pw
        return data, inputs

    run, data, proofs = _drive("conditional", device, build, POSEIDON_PATH,
                               proves=2)
    _reject_tampered("conditional, condition 0", data, proofs[1])
    return run


@phase("dummy-2^14-poseidon2")
def dummy_2_14_poseidon2(device):
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    return _drive("dummy-2^14-poseidon2", device,
                  _dummy_build(CONFIGS[P2], device), POSEIDON2_PATH)[0]


# ---------------------------------------------------------------------------
# the proving-service surface: batches, zero knowledge, compressed proofs,
# circuit files
# ---------------------------------------------------------------------------

class _OpCounter:
    """Counts the aten ops dispatched while it is entered (each is one
    kernel launch or more): the launches of a prove beside the exact counts
    of the hand kernels."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.ops += 1
                return func(*args, **(kwargs or {}))
        self.ops = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _builder_rng(data):
    """The numpy Generator the circuit's random-value generators share (the
    builder's): its state decides the random wires of the next prove."""
    from plonky2_tpu_torch.iop.generator import RandomValueGenerator
    rngs = {id(g.rng): g.rng for g in data.prover_only.generators
            if isinstance(g, RandomValueGenerator)}
    assert len(rngs) == 1, len(rngs)
    return next(iter(rngs.values()))


def _proof_bytes(data, proof) -> bytes:
    from plonky2_tpu_torch.utils.serialization import (
        serialize_proof_with_pis,
    )
    return serialize_proof_with_pis(proof, data.common)


BATCH_SIZES = (4, 3)


def _batch_vs_serial(name: str, device, data, kernels: tuple,
                     sizes=BATCH_SIZES):
    """prove_batch of max(sizes) distinct dummy witnesses (public input 0 =
    42 + i), cold and warm, the same witnesses through serial `prove`, then
    the other batch sizes; the builder's random stream is rewound before
    each, so every batched proof must equal its serial twin byte for byte.
    Logs seconds, hand-kernel launches and aten ops a proof, and peak
    memory, batched and serial. Returns the phase's (launches, shapes, warm
    shapes) and the serial proofs."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.plonk.batch_prover import prove_batch
    from plonky2_tpu_torch.recursion.dummy import dummy_witness

    B = max(sizes)
    pis = data.prover_only.public_inputs
    witnesses = [dummy_witness(pis, {0: 42 + i}) for i in range(B)]
    rng = _builder_rng(data)
    start = copy.deepcopy(rng.bit_generator.state)

    def rewind():
        rng.bit_generator.state = copy.deepcopy(start)

    def timed(fn):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
        kernel0 = sum(k.launches for k in backend.KERNELS.values())
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        launched = sum(k.launches for k in backend.KERNELS.values()) - kernel0
        shapes = {k.name: {s: n - before[k.name].get(s, 0)
                           for s, n in k.shapes.items()
                           if n > before[k.name].get(s, 0)}
                  for k in backend.KERNELS.values()}
        return out, seconds, launched, torch.cuda.max_memory_allocated(
            device), shapes

    torch.cuda.synchronize(device)
    backend.reset_counts()
    rewind()
    with _OpCounter() as ops:
        cold = prove_batch(data.prover_only, data.common, witnesses)
    batch_ops = ops.ops
    rewind()
    batch, t_batch, k_batch, peak_batch, warm = timed(
        lambda: prove_batch(data.prover_only, data.common, witnesses))
    rewind()
    serial, t_serial, k_serial, peak_serial, _ = timed(
        lambda: [data.prove(w) for w in witnesses])
    rewind()
    with _OpCounter() as ops:
        again = data.prove(witnesses[0])
    serial_ops = ops.ops
    want = [_proof_bytes(data, p) for p in serial]
    for what, proofs in (("cold batch", cold), ("warm batch", batch)):
        got = [_proof_bytes(data, p) for p in proofs]
        if got != want:
            raise AssertionError(f"{name}: {what} of {B} differs from the "
                                 f"serial proofs")
    if _proof_bytes(data, again) != want[0]:
        raise AssertionError(f"{name}: a serial prove is not reproducible")
    if len(set(want)) != B:
        raise AssertionError(f"{name}: distinct witnesses, equal proofs")
    log(f"{name}: B = {B} batched proofs equal the serial ones byte for "
        f"byte (cold and warm)")
    log(f"{name}: batch B = {B}: {t_batch:.3f} s, {t_batch / B:.3f} s a "
        f"proof, {k_batch / B:.1f} hand-kernel launches and "
        f"{batch_ops / B:.0f} aten ops a proof, peak {peak_batch / 2**20:.1f}"
        f" MiB; serial: {t_serial / B:.3f} s a proof, {k_serial / B:.1f} "
        f"hand-kernel launches and {serial_ops} aten ops a proof, peak "
        f"{peak_serial / 2**20:.1f} MiB; seconds a proof batch/serial "
        f"{t_batch / t_serial:.3f}, aten ops a proof serial/batch "
        f"{serial_ops * B / batch_ops:.2f}")
    for b in sizes:
        if b == B:
            continue
        rewind()
        proofs, t_b, k_b, peak_b, _ = timed(
            lambda: prove_batch(data.prover_only, data.common,
                                witnesses[:b]))
        if [_proof_bytes(data, p) for p in proofs] != want[:b]:
            raise AssertionError(f"{name}: the batch of {b} differs from "
                                 f"its serial proofs")
        log(f"{name}: batch B = {b} equals its serial proofs: {t_b:.3f} s, "
            f"{t_b / b:.3f} s a proof, {k_b / b:.1f} hand-kernel launches "
            f"a proof, peak {peak_b / 2**20:.1f} MiB")
    t0 = time.perf_counter()
    for p in batch:
        data.verify(p)
    log(f"{name}: every proof verifies ({(time.perf_counter() - t0) / B:.3f}"
        f" s each)")
    _reject_tampered(name, data, batch[-1])
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched by the main "
                             f"path: {missing}")
    log(f"{name}: launches {launches}")
    log(f"{name}: warm batch shapes "
        f"{ {k: v for k, v in warm.items() if k not in FIELD_KERNELS} }")
    return (launches, shapes, warm), serial


@phase("batch-dummy-2^14")
def batch_dummy_2_14(device, data):
    """The dummy-2^14 circuit of phase 5 (its data reused) through
    prove_batch at B = 4 and 3 against serial proves."""
    return _batch_vs_serial("batch-dummy-2^14", device, data, POSEIDON_PATH)


@phase("batch-dummy-2^14-poseidon2")
def batch_dummy_2_14_poseidon2(device):
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    data = _dummy_build(CONFIGS[P2], device)()[0]
    return _batch_vs_serial("batch-dummy-2^14-poseidon2", device, data,
                            POSEIDON2_PATH, sizes=(2,))[0]


ZK_STEPS = 30
ZK_SALT_SEED = 2024


@phase("zk-fib")
def zk_fib(device):
    """fib(31) under standard_recursion_zk_config(): blinding lays it out
    at 2^14. A cold and a warm prove with unseeded salts (both verify, their
    wire caps differ), two proves with one seeded salt stream and the
    builder's random stream rewound (equal bytes), tampers refused; the
    proof's bytes to chiprun_out/ for the JAX verifier."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import service_circuits as sc

    holder = {}

    def build():
        builder, inputs = sc.fib(PORT, ZK_STEPS, sc.ZK_SEED,
                                 "standard_recursion_zk_config")
        holder["inputs"] = inputs
        return (builder.build(device=device),
                lambda proofs: inputs(*sc.ZK_INPUTS))
    run, data, proofs = _drive("zk-fib", device, build, POSEIDON_PATH,
                               proves=2)
    common = data.common
    if not common.fri_params.hiding or common.degree_bits != 14:
        raise AssertionError(f"zk-fib: hiding {common.fri_params.hiding}, "
                             f"degree 2^{common.degree_bits}")
    if proofs[0].proof.wires_cap == proofs[1].proof.wires_cap:
        raise AssertionError("zk-fib: two unseeded proofs share a wires cap")
    rng = _builder_rng(data)
    state = copy.deepcopy(rng.bit_generator.state)
    seeded = []
    for _ in range(2):
        rng.bit_generator.state = copy.deepcopy(state)
        seeded.append(data.prove(holder["inputs"](*sc.ZK_INPUTS),
                                 rng=np.random.default_rng(ZK_SALT_SEED)))
    if _proof_bytes(data, seeded[0]) != _proof_bytes(data, seeded[1]):
        raise AssertionError("zk-fib: two seeded proves differ")
    data.verify(seeded[0])
    log(f"zk-fib: degree 2^{common.degree_bits} after blinding, "
        f"unseeded proofs differ and verify, seeded proofs equal "
        f"({len(_proof_bytes(data, seeded[0]))} bytes)")
    _write_proof("zk_fib_proof.bin", data, proofs[0])
    return run, data, proofs[0]


@phase("compressed")
def compressed(device, cases):
    """Each (name, data, proof): compressed, serialized, read back,
    decompressed to the original bytes, verified by `verify_compressed`;
    a tampered compressed proof refused. The dummy-2^14 proof's compressed
    bytes go to chiprun_out/ for the JAX verifier."""
    from plonky2_tpu_torch.utils import serialization as ser
    for name, data, proof in cases:
        t0 = time.perf_counter()
        comp = data.compress(proof)
        raw = ser.serialize_compressed_proof_with_pis(comp, data.common)
        t1 = time.perf_counter()
        back = ser.deserialize_compressed_proof_with_pis(raw, data.common)
        restored = data.decompress(back)
        t2 = time.perf_counter()
        if _proof_bytes(data, restored) != _proof_bytes(data, proof):
            raise AssertionError(f"compressed {name}: decompression does "
                                 f"not restore the proof")
        data.verify_compressed(back)
        bad = copy.deepcopy(back)
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
        try:
            data.verify_compressed(bad)
        except (AssertionError, KeyError) as e:
            log(f"compressed {name}: flipped public input rejected ({e})")
        else:
            raise AssertionError(f"compressed {name}: a tampered compressed "
                                 f"proof verified")
        full = len(_proof_bytes(data, proof))
        log(f"compressed {name}: {len(raw)} bytes against {full} "
            f"({len(raw) / full:.3f}); compress + serialize {t1 - t0:.3f} s,"
            f" read + decompress {t2 - t1:.3f} s")
        if name == "dummy-2^14":
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, "dummy_2_14_compressed.bin"),
                      "wb") as f:
                f.write(raw)
            log(f"{len(raw)} compressed proof bytes written to "
                f"chiprun_out/dummy_2_14_compressed.bin")


@phase("circuit-serialization")
def circuit_serialization(device):
    """The dummy-2^14 CircuitData saved and loaded on the card (its
    constants committed anew through K1, K3 and K2): the loaded prover's
    proof, from the original's random stream, equals the original's bytes;
    the verifier data from the blob verifies it. Returns the phase's
    (launches, shapes, warm shapes): the counts cover the load and its
    prove."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.hash.hashers import PoseidonGoldilocksConfig
    from plonky2_tpu_torch.recursion.dummy import dummy_witness
    from plonky2_tpu_torch.utils import circuit_serialization as cs

    t0 = time.perf_counter()
    data = _dummy_build(PoseidonGoldilocksConfig, device)()[0]
    torch.cuda.synchronize(device)
    build_seconds = time.perf_counter() - t0
    witness = dummy_witness(data.prover_only.public_inputs, {0: 42})
    state = copy.deepcopy(_builder_rng(data).bit_generator.state)
    want = _proof_bytes(data, data.prove(witness))
    t0 = time.perf_counter()
    blob = cs.serialize_circuit_data(data)
    t_save = time.perf_counter() - t0
    vblob = cs.serialize_verifier_circuit_data(data.verifier_data())
    torch.cuda.synchronize(device)
    backend.reset_counts()
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    t0 = time.perf_counter()
    loaded = cs.deserialize_circuit_data(blob, device=device, rng=rng)
    torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    load_launches = {k.name: k.launches for k in backend.KERNELS.values()}
    proof = loaded.prove(witness)
    torch.cuda.synchronize(device)
    if _proof_bytes(loaded, proof) != want:
        raise AssertionError("circuit-serialization: the loaded circuit's "
                             "proof differs from the original's")
    verifier = cs.deserialize_verifier_circuit_data(vblob)
    verifier.verify(proof)
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
    missing = [k for k in ("ntt", "poseidon_hash_leaves",
                           "poseidon_merkle_tree") if load_launches[k] == 0]
    if missing:
        raise AssertionError(f"circuit-serialization: the load launched no "
                             f"{missing}")
    log(f"circuit-serialization: blob {len(blob)} bytes (verifier data "
        f"{len(vblob)}), save {t_save:.3f} s, load on the card "
        f"{t_load:.3f} s against the build's {build_seconds:.3f} s; the "
        f"loaded circuit proves the original's bytes; load launches "
        f"{load_launches}")
    return launches, shapes, {k: {} for k in launches}


# the package tests/gadget_circuits.py builds the gadget phases' circuits
# with (it imports only the package it is given)
PORT = "plonky2_tpu_torch"
# the degree and gate types of the reference's in-circuit Schnorr
# verification (3,231 rows before padding)
SCHNORR_DEGREE_BITS = 12
SCHNORR_GATE_TYPES = 13
U32_GATES = ("U32ArithmeticGate", "U32AddManyGate", "U32SubtractionGate",
             "ComparisonGate", "U32RangeCheckGate")


def _round3_by_gate(name: str, common, device) -> None:
    """Each gate type's `eval_unfiltered_rows` alone over a grid of round
    3's size (degree x 8 points) of random rows on the card, beside the
    median round 3 of the drive's warm proves: the gates' shares of it."""
    from plonky2_tpu_torch.field import goldilocks as gl
    rng = np.random.default_rng(3)
    n = common.degree << (common.quotient_degree_factor - 1).bit_length()
    nc = common.num_constants - common.selectors_info.num_selectors
    args = [gl.from_u64(rng.integers(0, P, size=(k, n), dtype=np.uint64),
                        device) for k in (nc, common.config.num_wires, 4)]
    round3 = statistics.median(s["round 3"] for s in
                               STEP_SECONDS[name][1:])
    parts = []
    for g in common.gates:
        _, ms = _timed_ms(lambda: g.eval_unfiltered_rows(*args))
        parts.append((ms, g.id()))
    log(f"{name}: round 3 by gate over {n} rows (eval_unfiltered_rows "
        f"alone; warm round 3 median {round3:.3f} s): "
        + "; ".join(f"{gid} {ms:.1f} ms {ms / 1e3 / round3:.1%}"
                    for ms, gid in sorted(parts, reverse=True)))
    del args
    torch.cuda.empty_cache()


@phase("schnorr-ecgfp5")
def schnorr_ecgfp5(device):
    """The reference's in-circuit Schnorr verification over EcGFp5
    (ecgfp5/gadgets/schnorr.rs:82-105) at its full size: built, proved cold
    and WARM_PROVES times warm, verified and tampered; its cold proof's
    bytes go to chiprun_out/; the same circuit over a signature with s + 1
    must make no witness."""
    import gadget_circuits as circuits
    from plonky2_tpu_torch.iop.generator import generate_partial_witness

    def build():
        builder, pw = circuits.schnorr(PORT)
        return builder.build(device=device), lambda proofs: pw
    run, data, (proof, *_) = _drive("schnorr-ecgfp5", device, build,
                                    POSEIDON_PATH)
    common = data.common
    if (common.degree_bits, len(common.gates)) != (SCHNORR_DEGREE_BITS,
                                                   SCHNORR_GATE_TYPES):
        raise AssertionError(f"schnorr-ecgfp5: degree 2^{common.degree_bits}"
                             f" and {len(common.gates)} gate types")
    _write_proof("schnorr_ecgfp5_proof.bin", data, proof)
    _round3_by_gate("schnorr-ecgfp5", common, device)
    builder, pw = circuits.schnorr(PORT, tamper=True)
    t0 = time.perf_counter()
    host = builder.build_host()
    try:
        generate_partial_witness(pw, host, host.common)
    except AssertionError as e:
        log(f"schnorr-ecgfp5: the signature with s + 1 makes no witness "
            f"(build_host + fixpoint {time.perf_counter() - t0:.3f} s: "
            f"{str(e)[:160]})")
    else:
        raise AssertionError("schnorr-ecgfp5: a signature with s + 1 made a "
                             "witness")
    return run, common.gates


@phase("secp256k1-curve")
def secp256k1_curve(device):
    """tests/test_curve_gadgets.py's add/double circuit over secp256k1 under
    standard_ecc_config() (136 wires, all five u32 gates): built, proved
    cold and once warm, verified and tampered; add, double and neg in the
    witness equal the native curve's; the cold proof's bytes go to
    chiprun_out/."""
    import gadget_circuits as circuits
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    made = {}

    def build():
        builder, made["pw"], made["points"] = circuits.secp256k1_curve(PORT)
        return builder.build(device=device), lambda proofs: made["pw"]
    run, data, (proof, *_) = _drive("secp256k1-curve", device, build,
                                    POSEIDON_PATH, proves=2)
    kinds = {g.id().split(" ")[0] for g in data.common.gates}
    if not set(U32_GATES) <= kinds or data.common.config.num_wires != 136:
        raise AssertionError(f"secp256k1-curve: gate types {sorted(kinds)}, "
                             f"{data.common.config.num_wires} wires")
    witness = generate_partial_witness(made["pw"], data.prover_only,
                                       data.common)
    for name, (t, want) in made["points"].items():
        if circuits.point_value(PORT, witness, t) != want:
            raise AssertionError(f"secp256k1-curve: {name} differs from the "
                                 f"native curve")
    log("secp256k1-curve: add, double and neg equal the native curve's; "
        f"the five u32 gate types among {len(kinds)}")
    _write_proof("secp256k1_curve_proof.bin", data, proof)
    _round3_by_gate("secp256k1-curve", data.common, device)
    return run, data.common.gates


@phase("lookups")
def lookups(device):
    """tests/test_lookup.py's test_two_luts circuit: built, proved once,
    verified, tampered; its public inputs are the test's."""
    import gadget_circuits as circuits
    made = {}

    def build():
        builder, pw, made["want"] = circuits.two_luts(PORT)
        return builder.build(device=device), lambda proofs: pw
    run, data, (proof, *_) = _drive("lookups", device, build, POSEIDON_PATH,
                                    proves=1)
    if proof.public_inputs != made["want"]:
        raise AssertionError(f"lookups: public inputs {proof.public_inputs},"
                             f" want {made['want']}")
    log(f"lookups: public inputs {proof.public_inputs} as the test's")
    _write_proof("lookups_proof.bin", data, proof)
    return run, data.common.gates


# rows of the gates-on-the-card check
GATE_ROWS = 1 << 13
NEW_GATES = U32_GATES + ("MulGFp5Gate", "LookupGate")


@phase("gates on the card")
def gates_on_card(device, laid_out):
    """Round 3's evaluation of each new gate (`eval_unfiltered_rows`, the
    generic `eval_unfiltered` on GFAlgebra) over GATE_ROWS rows of random
    canonical wires, constants and public-input hash on the card, bit-equal
    to the same call on the CPU: every new gate the gadget phases laid out,
    and the ones no path lays out (LookupTableGate, the two interpolation
    gates, PoseidonMdsGate)."""
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.gates.interpolation_gates import (
        HighDegreeInterpolationGate, LowDegreeInterpolationGate,
    )
    from plonky2_tpu_torch.gates.lookup_gates import LookupTableGate
    from plonky2_tpu_torch.gates.misc_gates import PoseidonMdsGate

    gates = {g.id(): g for g in laid_out
             if g.id().split(" ")[0] in NEW_GATES}
    lut = next(g.lut for g in gates.values() if g.id().startswith("Lookup"))
    for g in (LookupTableGate(26, lut, 0), HighDegreeInterpolationGate(2),
              LowDegreeInterpolationGate(2), PoseidonMdsGate()):
        gates[g.id()] = g
    rng = np.random.default_rng(9)
    for gate_id, g in sorted(gates.items()):
        arrays = [rng.integers(0, P, size=(n, GATE_ROWS), dtype=np.uint64)
                  for n in (2, g.num_wires(), 4)]
        args = [gl.from_u64(a, device) for a in arrays]
        got, ms = _timed_ms(lambda: g.eval_unfiltered_rows(*args))
        t0 = time.perf_counter()
        want = g.eval_unfiltered_rows(*(gl.from_u64(a, "cpu")
                                        for a in arrays))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if got.shape != (g.num_constraints(), GATE_ROWS) or \
                not torch.equal(got.cpu(), want):
            raise AssertionError(f"{gate_id}: the card's round-3 evaluation "
                                 f"differs from the CPU's")
        log(f"{gate_id}: {g.num_constraints()} constraints over "
            f"{GATE_ROWS} rows bit-equal to the CPU; card {ms:.3f} ms, CPU "
            f"{cpu_ms:.3f} ms")
    log(f"gates on the card: {len(gates)} gates checked")


STARK_ROWS = 1 << 20
WIDE_LANES = 64
STARK_DEGREE_BITS = 20
P2_STARK_ROWS = 1 << 16


def _stark_config():
    from plonky2_tpu_torch.starky.config import StarkConfig
    return StarkConfig.standard_fast_config()


def _stark_drive(name: str, device, prove, verify, kernels: tuple,
                 proves: int):
    """Prove one STARK system `proves` times (a cold prove, then warm ones)
    and verify every proof; the counts are set to 0 just before and read
    just after. `prove(timing)` returns a proof, its TimingTree scopes
    ending in a synchronize; each prove's scopes are logged. Returns ((launches,
    shapes, warm shapes), proofs) as `_drive` does."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.utils.timing import TimingTree

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    backend.reset_counts()
    times, proofs, scopes = [], [], []
    for _ in range(proves):
        before = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
        timing = TimingTree(name, enabled=True)
        t0 = time.perf_counter()
        proofs.append(prove(timing))
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        scopes.append(timing.seconds())
    warm = {k.name: {s: n - before[k.name].get(s, 0)
                     for s, n in k.shapes.items()
                     if n > before[k.name].get(s, 0)}
            for k in backend.KERNELS.values()}
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = {k.name: dict(k.shapes) for k in backend.KERNELS.values()}
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    for proof in proofs:
        verify(proof)
    t_verify = (time.perf_counter() - t0) / len(proofs)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched by the main "
                             f"path: {missing}")
    warm_s = (f"warm x{proves - 1} median {statistics.median(times[1:]):.3f}"
              f" s ({min(times[1:]):.3f}-{max(times[1:]):.3f} s)"
              if proves > 1 else "no warm prove")
    log(f"{name}: prove cold {times[0]:.3f} s, {warm_s}, verify "
        f"{t_verify:.3f} s, peak allocated {peak / 2**20:.1f} MiB")
    for i, sc_ in enumerate(scopes):
        log(f"{name}: {'cold' if i == 0 else 'warm'} prove {times[i]:.3f} s"
            f" by scope: " + "; ".join(f"{k} {v:.3f} s"
                                       for k, v in sc_.items()))
    log(f"{name}: launches {launches}")
    return (launches, shapes, warm), proofs


def _reject(name: str, what: str, check) -> None:
    """`check()` must raise an AssertionError."""
    try:
        check()
    except AssertionError as e:
        log(f"{name}: {what} rejected ({str(e)[:160]})")
    else:
        raise AssertionError(f"{name}: {what} was accepted")


def _stark_tampered(name: str, stark, proof, config, gc=None):
    """A flipped trace opening, then a changed last public input where the
    constraints read the public inputs (PermutationStark's do not), must
    fail verify_stark_proof."""
    from plonky2_tpu_torch.starky.verifier import verify_stark_proof
    bad = copy.deepcopy(proof)
    v = bad.proof.openings.local_values[0]
    bad.proof.openings.local_values[0] = ((v[0] + 1) % P, v[1])
    out = [("flipped trace opening", bad)]
    if type(stark).__name__ != "PermutationStark":
        bad = copy.deepcopy(proof)
        bad.public_inputs[-1] = (bad.public_inputs[-1] + 1) % P
        out.append(("public input + 1", bad))
    for what, bad in out:
        _reject(name, what, lambda: verify_stark_proof(stark, bad, config,
                                                       gc=gc))


def _stark_phase(name: str, device, system, proves: int, gc=None,
                 kernels=POSEIDON_PATH):
    """Prove a single-table STARK `proves` times, verify, tamper."""
    from plonky2_tpu_torch.starky.prover import prove
    from plonky2_tpu_torch.starky.verifier import verify_stark_proof

    config = _stark_config()
    t0 = time.perf_counter()
    stark, trace, pis = system()
    log(f"{name}: {type(stark).__name__}, {stark.COLUMNS} columns x "
        f"{trace.shape[1]} rows, {len(pis)} public inputs, trace made on the "
        f"host in {time.perf_counter() - t0:.3f} s, FRI arities "
        f"{config.fri_params(trace.shape[1].bit_length() - 1).reduction_arity_bits}")
    run, proofs = _stark_drive(
        name, device,
        lambda timing: prove(stark, config, trace, pis, timing, gc=gc,
                             device=device),
        lambda proof: verify_stark_proof(stark, proof, config, gc=gc),
        kernels, proves)
    if proofs[0].public_inputs != list(pis):
        raise AssertionError(f"{name}: public inputs differ")
    _stark_tampered(name, stark, proofs[0], config, gc)
    return run, stark, proofs[0]


@phase("starky-fib")
def starky_fib(device):
    """The reference's FibonacciStark at 2^20 rows from (0, 1): proved cold
    and STARK_WARM_PROVES times warm, verified, a result + 1 rejected."""
    import stark_circuits as circuits
    run, stark, proof = _stark_phase(
        "starky-fib", device, lambda: circuits.fibonacci(PORT, STARK_ROWS),
        1 + STARK_WARM_PROVES)
    if proof.public_inputs[2] != circuits.fib(STARK_ROWS - 1, 0, 1):
        raise AssertionError("starky-fib: the result is not fib(2^20 - 1)")
    return run, stark, proof


@phase("starky-wide")
def starky_wide(device):
    """64 Fibonacci lanes (128 columns) over 2^20 rows from seeded values:
    proved cold and twice warm, verified, tampered."""
    import stark_circuits as circuits
    return _stark_phase(
        "starky-wide", device,
        lambda: circuits.wide_fibonacci(PORT, WIDE_LANES, STARK_ROWS), 3)[0]


@phase("starky-logup")
def starky_logup(device):
    """PermutationStark at 2^20 rows (logUp helper columns, their inverses
    over every row, the running sum): proved cold and once warm, verified;
    a trace that is no permutation gives a proof that fails."""
    from plonky2_tpu_torch.starky.permutation_stark import PermutationStark
    from plonky2_tpu_torch.starky.prover import prove
    from plonky2_tpu_torch.starky.verifier import verify_stark_proof

    def system():
        stark = PermutationStark()
        return stark, stark.generate_trace(7, STARK_ROWS), [7]
    run, stark, _ = _stark_phase("starky-logup", device, system, 2)
    config = _stark_config()
    trace = stark.generate_trace(7, STARK_ROWS)
    trace[0][3] = 12345
    bad = prove(stark, config, trace, [7], device=device)
    _reject("starky-logup", "a trace that is no permutation",
            lambda: verify_stark_proof(stark, bad, config))
    return run


@phase("starky-ctl")
def starky_ctl(device):
    """tests/test_ctl.py's two tables at 2^20 rows each through prove_multi
    (cold and once warm) and verify_multi; a multiset mismatch fails."""
    import stark_circuits as circuits
    from plonky2_tpu_torch.starky.prover import prove_multi
    from plonky2_tpu_torch.starky.verifier import verify_multi

    config = _stark_config()
    starks, traces, ctls, pis = circuits.ctl_system(PORT, STARK_ROWS)
    run, proofs = _stark_drive(
        "starky-ctl", device,
        lambda timing: prove_multi(starks, config, traces, ctls, pis, timing,
                                   device=device),
        lambda mp: verify_multi(starks, mp, config, ctls), POSEIDON_PATH, 2)
    zs = [p.proof.openings.ctl_zs_first for p in proofs[0].stark_proofs]
    log(f"starky-ctl: 2 tables x {STARK_ROWS} rows, Z openings at x = 1 "
        f"{zs}")
    starks, traces, ctls, pis = circuits.ctl_system(PORT, STARK_ROWS,
                                                    mismatch=True)
    bad = prove_multi(starks, config, traces, ctls, pis, device=device)
    _reject("starky-ctl", "a multiset mismatch",
            lambda: verify_multi(starks, bad, config, ctls))
    return run


@phase("starky-recursive")
def starky_recursive(device, stark, stark_proof):
    """The starky-fib proof verified inside a plonky2 circuit
    (standard_recursion_config(), seed 1234): built (its host layout timed
    apart), proved cold and STARK_WARM_PROVES times warm on the card,
    verified,
    tampered, its public inputs the STARK's; a STARK proof with one FRI
    opening flipped makes no witness."""
    import stark_circuits as circuits
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import commit
    from plonky2_tpu_torch.starky.recursive_verifier import (
        set_stark_proof_with_pis_target,
    )

    config = _stark_config()
    made = {}

    def witness(proof):
        pw = PartialWitness()
        set_stark_proof_with_pis_target(pw, made["pt"], proof)
        return pw

    def build():
        t0 = time.perf_counter()
        builder, made["pt"] = circuits.stark_verifier_circuit(
            PORT, stark, config, STARK_DEGREE_BITS)
        made["host"] = builder.build_host()
        made["host_s"] = time.perf_counter() - t0
        return commit(made["host"], device), lambda proofs: witness(
            stark_proof)
    run, data, proofs = _drive("starky-recursive", device, build,
                               POSEIDON_PATH, 1 + STARK_WARM_PROVES)
    log(f"starky-recursive: layout + build_host {made['host_s']:.3f} s of "
        f"the build, {len(data.common.gates)} gate types")
    if proofs[0].public_inputs != list(stark_proof.public_inputs):
        raise AssertionError("starky-recursive: its public inputs are not "
                             "the STARK's")
    bad = copy.deepcopy(stark_proof)
    evals = bad.proof.opening_proof.query_round_proofs[0] \
        .initial_trees_proof.evals_proofs[0][0]
    evals[0] = (int(evals[0]) + 1) % P

    def tampered():
        host = made["host"]
        generate_partial_witness(witness(bad), host, host.common)
    _reject("starky-recursive", "a STARK proof with a flipped FRI opening",
            tampered)
    return run


@phase("starky-poseidon2")
def starky_poseidon2(device):
    """FibonacciStark at 2^16 rows under Poseidon2GoldilocksConfig: proved
    once, verified, tampered."""
    import stark_circuits as circuits
    from plonky2_tpu_torch.hash.hashers import CONFIGS
    return _stark_phase(
        "starky-poseidon2", device,
        lambda: circuits.fibonacci(PORT, P2_STARK_ROWS), 1, gc=CONFIGS[P2],
        kernels=POSEIDON2_PATH)[0]


def _wrapper_ms(fn, reps: int) -> float:
    """ms per call of `reps` back-to-back calls, CUDA events: the host's
    time whenever that is longer than the kernels'."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_ms(fn) -> tuple:
    """(output, host ms) of one call that ends in a synchronize: the plain
    versions, whose one call is both compared and timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_ms(fn, reps: int) -> float:
    """ms per call on the device: CUDA events around `reps` calls queued
    behind a sleep kernel (~25 ms), so they run back to back whatever the
    host's time per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flat(out) -> torch.Tensor:
    """A kernel's output as one tensor (the tree's layers concatenated)."""
    if isinstance(out, list):
        return torch.cat(out) if out else torch.empty(0, dtype=torch.int64)
    return out


def _max_abs_err(a, b) -> int:
    a, b = _flat(a), _flat(b)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    ua = a.cpu().numpy().view(np.uint64).reshape(-1)
    ub = b.cpu().numpy().view(np.uint64).reshape(-1)
    diff = np.nonzero(ua != ub)[0]
    return max(abs(int(ua[i]) - int(ub[i])) for i in diff)


def _bound(name: str, shape, clock_mhz: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function moves over
    HBM bandwidth and the 32-bit multiply-adds its field multiplies need
    (IMAD_PER_FIELD_MUL each) over the card's IMAD rate at `clock_mhz`.
    Adds, reductions and small-constant products are not counted: a
    floor."""
    if name == "ntt":
        # B n read and B N written: the twiddles and the shift or scale
        # powers can be made on chip, so the kernel's tables of them are not
        # counted; one general multiply per butterfly of the stages not
        # skipped, and one per element for the shift (forward) or the scale
        # (inverse)
        batch, lg_n, rate, direction, shift = shape
        n, N = 1 << lg_n, 1 << (lg_n + rate)
        nbytes = 8 * (batch * n + batch * N)
        scaled = shift is not None or direction == "inverse"
        muls = batch * (lg_n * (N // 2) + (n if scaled else 0))
        imads = IMAD_PER_FIELD_MUL * muls
    elif name.endswith("_permute"):
        nbytes = 2 * 8 * 12 * shape[0]
        imads = FIELD_MULS[name] * IMAD_PER_FIELD_MUL * shape[0]
    elif name.endswith("_merkle_tree"):
        # n leaf digests in, the n - 2^cap nodes above them out, one
        # compression (permutation) per node
        n, cap_height = shape
        nodes = n - (1 << cap_height)
        nbytes = 32 * (n + nodes)
        perm = name.replace("merkle_tree", "permute")
        imads = FIELD_MULS[perm] * IMAD_PER_FIELD_MUL * nodes
    else:
        L, n = shape
        perm = name.replace("hash_leaves", "permute")
        nbytes = 8 * (L * n + 4 * n)
        imads = (FIELD_MULS[perm] * IMAD_PER_FIELD_MUL * n
                 * math.ceil(L / 8))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# shapes held beside those the proofs launched: the K4/K5 batch sizes of the
# TPU and the small batches of K6 (compress levels, now served by the tree
# kernels), every tree of the dummy-2^14 proofs, K6 on the 2^21-leaf tree
# of a STARK of 2^20 rows, and K7 on zk-fib's salted leaves (wires, Z)
TREES = [(1 << 17, 4), (1 << 13, 4), (1 << 9, 4), (1 << 5, 4)]
SMALL = [(256,), (128,), (64,), (32,), (16,)]
EXTRA_SHAPES = {"poseidon_permute": SMALL, "poseidon_merkle_tree": TREES,
                "poseidon2_permute": SMALL,
                "poseidon2_merkle_tree": TREES + [(1 << 21, 4)],
                "poseidon2_hash_leaves": [(139, 1 << 17), (24, 1 << 17)]}
# above these sizes the plain version (PyTorch ops, on the card) is held on
# a seeded sample: K1 on rows of its batch, a tree on one subtree of 2^17
# leaves, a leaf hash on 2^16 leaves (rows, subtrees and leaves are
# independent, so a sample is a full check of what it covers)
NTT_FULL_ELEMS = 1 << 25
TREE_FULL_LEAVES = 1 << 17
LEAVES_FULL_ELEMS = 1 << 25
LEAF_SAMPLE = 1 << 16
BATCH_SUBTREES = 4


def _cases(name, shape, rand, rng):
    """(kernel call, plain call, size, pick, sample): `pick` takes from the
    kernel's output what `plain` computes (all of it, or the sample that
    `sample` names)."""
    from plonky2_tpu_torch.hash import poseidon as ps
    from plonky2_tpu_torch.hash import poseidon2 as ps2
    from plonky2_tpu_torch.ops import ntt

    whole = lambda out: out
    if name == "ntt":
        batch, lg_n, rate, direction, shift = shape
        x = rand(batch, 1 << lg_n)
        N = 1 << (lg_n + rate)
        rows = torch.arange(batch)
        if batch * N > NTT_FULL_ELEMS:
            k = max(1, (NTT_FULL_ELEMS >> 1) // N)
            rows = torch.from_numpy(np.sort(rng.choice(batch, k,
                                                       replace=False)))
        rows = rows.to(x.device)
        xs = x.index_select(0, rows)
        pick = whole if len(rows) == batch else \
            (lambda out: out.index_select(0, rows))
        sample = None if len(rows) == batch else f"{len(rows)} of {batch} rows"
        if direction == "inverse":
            return (lambda: ntt.inverse(x, shift),
                    lambda: ntt.inverse_plain(xs, shift), x.numel(), pick,
                    sample)
        return (lambda: ntt.forward(x, rate, shift),
                lambda: ntt.forward_plain(xs, rate, shift), x.numel() << rate,
                pick, sample)
    mod = ps2 if name.startswith("poseidon2") else ps
    if name.endswith("_merkle_tree"):
        n, cap_height = shape
        d = rand(n, 4)
        if n <= TREE_FULL_LEAVES:
            return (lambda: mod.merkle_layers(d, cap_height),
                    lambda: mod.merkle_layers_plain(d, cap_height), n, whole,
                    None)
        # subtree t: the leaves [t m, (t + 1) m); layer l holds its nodes
        # [t m / 2^l, (t + 1) m / 2^l). A batch's tree (B proofs' trees side
        # by side, at most BATCH_SUBTREES of them) is held subtree by
        # subtree, against B plain trees; a longer one on one seeded subtree
        m = TREE_FULL_LEAVES
        k = min(m.bit_length() - 1, (n.bit_length() - 1) - cap_height)
        ts = (list(range(n // m)) if n // m <= BATCH_SUBTREES
              else [int(rng.integers(0, n // m))])
        return (lambda: mod.merkle_layers(d, cap_height),
                lambda: [layer for t in ts for layer in
                         mod.merkle_layers_plain(
                             d[t * m:(t + 1) * m], (m.bit_length() - 1) - k)],
                n,
                lambda layers: [layers[l - 1][t * (m >> l):(t + 1) * (m >> l)]
                                for t in ts for l in range(1, k + 1)],
                (f"each of its {n // m} subtrees of {m} leaves" if len(ts) > 1
                 else f"subtree {ts[0]} of {n // m} ({m} leaves)"))
    if name.endswith("_permute"):
        s = rand(shape[0], 12)
        return (lambda: mod.permute(s), lambda: mod.permute_plain(s),
                s.numel(), whole, None)
    x = rand(*shape)
    if x.numel() <= LEAVES_FULL_ELEMS:
        return (lambda: mod.hash_leaves(x), lambda: mod.hash_leaves_plain(x),
                x.numel(), whole, None)
    idx = torch.from_numpy(np.sort(rng.choice(shape[1], LEAF_SAMPLE,
                                              replace=False))).to(x.device)
    xs = x.index_select(1, idx)
    return (lambda: mod.hash_leaves(x), lambda: mod.hash_leaves_plain(xs),
            x.numel(), lambda out: out.index_select(0, idx),
            f"{LEAF_SAMPLE} of {shape[1]} leaves")


# csrc/field.cu: the elementwise multiplies a call needs, for its bound
def _field_muls(op: str, exponent: int = 0) -> int:
    if op == "mul":
        return 1
    if op == "ext mul":
        return 4                  # a0 b0, a1 b1, a0 b1, a1 b0; 7 t is small
    if op == "exp":
        return max(exponent.bit_length() - 1, 0) + bin(exponent).count("1")
    return 0


def _field_cases(device, raw, halves):
    """(label, record, op, kernel call, plain call, operands read, field
    multiplies an element) of csrc/field.cu's checks: the main path's
    broadcast shapes (the partial products' [80, 1, 2^14] x [1, 4, 1] and
    their inverses over [80, 4, 2^14], the alpha reduction's [num, N] x
    [num, 1], the STARK's [2, 2^21] rows), 0-d CUDA and CPU operands, a
    constant, transposed and sliced views, on raw 64-bit patterns (half of
    them edge values, canonical or not); reduce_lh on sums of halves below
    2^62."""
    from plonky2_tpu_torch.field import extension as ext
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field.extension import GF2

    n = 1 << 21
    pp, pb = raw(80, 1, 1 << 14), raw(1, 4, 1)
    polys, apow = raw(135, 1 << 17), raw(135, 1)
    rows, rows2 = raw(2, n), raw(2, n)
    x, y = raw(n), raw(n)
    cuda0, cpu0 = raw(), raw().cpu()
    wide, tall = raw(1 << 9, 1 << 13), raw(1 << 12, 1 << 9)
    lo, hi = halves(n), halves(n)
    a, b = GF2(raw(n), raw(n)), GF2(raw(n), raw(n))
    beta = GF2(raw(), raw())
    folds = GF2(raw(1 << 18, 8), raw(1 << 18, 8))
    cases = [
        ("mul [80, 1, 2^14] x [1, 4, 1]", "mul", gl.mul, gl.mul_plain,
         (pp, pb)),
        ("mul [135, 2^17] x [135, 1]", "mul", gl.mul, gl.mul_plain,
         (polys, apow)),
        ("add [2, 2^21]", "add", gl.add, gl.add_plain, (rows, rows2)),
        ("sub [2, 2^21]", "sub", gl.sub, gl.sub_plain, (rows, rows2)),
        ("mul [2, 2^21]", "mul", gl.mul, gl.mul_plain, (rows, rows2)),
        ("mul [2^21] x 0-d cuda", "mul", gl.mul, gl.mul_plain, (x, cuda0)),
        ("add 0-d cpu x [2^21]", "add", gl.add, gl.add_plain, (cpu0, x)),
        ("sub 0-d cuda x 0-d cpu", "sub", gl.sub, gl.sub_plain,
         (cuda0, cpu0)),
        ("mul [2^9, 2^13][:, ::2] x [2^12, 2^9].T", "mul", gl.mul,
         gl.mul_plain, (wide[:, ::2], tall.t())),
        ("sub [2, 2^21][:, 1:] x [2^21 - 1]", "sub", gl.sub, gl.sub_plain,
         (rows[:, 1:], y[1:])),
        ("neg [2^21]", "sub", gl.neg, gl.neg_plain, (x,)),
        ("mul_small 7 [2^21]", "mul", lambda t: gl.mul_small(t, 7),
         lambda t: gl.mul_small_plain(t, 7), (x,)),
        ("mul_const p - 2 [2^21]", "mul", lambda t: gl.mul_const(t, P - 2),
         lambda t: gl.mul_const_plain(t, P - 2), (x,)),
        ("add_const 2^40 [2^21]", "add", lambda t: gl.add_const(t, 1 << 40),
         lambda t: gl.add_const_plain(t, 1 << 40), (x,)),
        ("reduce_lh [2^21]", "reduce_lh", gl.reduce_lh, gl._reduce_lh,
         (lo, hi)),
        ("inverse [80, 4, 2^14]", "exp", gl.inverse,
         lambda t: gl.exp_plain(t, P - 2), (raw(80, 4, 1 << 14),)),
        ("inverse [2, 2^21]", "exp", gl.inverse,
         lambda t: gl.exp_plain(t, P - 2), (rows,)),
    ]
    cases = [(label, "field", op, run, plain, xs, _field_muls(
        op, P - 2 if "inverse" in label else 0))
        for label, op, run, plain, xs in cases]
    for e in (0, 1, 7, P - 1, (1 << 64) - 1):
        cases.append((f"exp {e} [2^16]", "field", "exp",
                      lambda t, e=e: gl.exp(t, e),
                      lambda t, e=e: gl.exp_plain(t, e), (x[:1 << 16],),
                      _field_muls("exp", e)))
    ext_cases = [
        ("ext add [2^21]", "add", (a, b)), ("ext sub [2^21]", "sub", (a, b)),
        ("ext mul [2^21]", "mul", (a, b)),
        ("ext mul [2^21] x 0-d cuda", "mul", (a, beta)),
        ("ext mul [2^18, 8][:, 3] x 0-d", "mul", (folds[:, 3], beta)),
        ("ext mul [135, 2^12] x [135, 1]", "mul",
         (GF2(polys[:, :1 << 12], polys[:, 1:1 + (1 << 12)]),
          GF2(apow, apow + 0)))]
    for label, op, (u, v) in ext_cases:
        cases.append((
            label, "field_ext", op,
            lambda a0, a1, b0, b1, op=op: getattr(GF2, f"__{op}__")(
                GF2(a0, a1), GF2(b0, b1)),
            lambda a0, a1, b0, b1, op=op: getattr(ext, f"{op}_plain")(
                GF2(a0, a1), GF2(b0, b1)),
            (u.c0, u.c1, v.c0, v.c1), _field_muls(f"ext {op}")))
    return cases


def _host_us(fn, reps: int = 2000) -> float:
    """Host microseconds a call of `fn` on tiny tensors: the kernels finish
    faster than the host enqueues them, so the host's time is the call's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _cuda_kernels(fn) -> int:
    """Kernels one call of `fn` launches on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


@phase("field")
def field(device, clock_mhz):
    """csrc/field.cu against the plain version (field/goldilocks.py and
    field/extension.py's `*_plain`, PyTorch ops on the card) at the cases of
    `_field_cases`, bit for bit; each case's device ms beside its bound and
    the plain version's ms; the host microseconds of a call and the kernels
    one op launches, kernel and plain. Returns the kernel table's entries
    of the two records."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field.extension import GF2
    from plonky2_tpu_torch.field import extension as ext

    rng = np.random.default_rng(20)
    edge = np.asarray(EDGE + [1 << 63, (1 << 64) - (1 << 32)],
                      dtype=np.uint64)
    sums = np.asarray([0, 1, (1 << 32) - 1, 1 << 32, (1 << 62) - 1],
                      dtype=np.int64)

    def mixed(x, values):
        pick = rng.random(x.shape) < 0.5
        x[pick] = values[rng.integers(0, len(values), size=int(pick.sum()))]
        return torch.from_numpy(x.view(np.int64)).to(device)

    def raw(*shape):
        return mixed(rng.integers(0, 1 << 64, size=shape, dtype=np.uint64),
                     edge)

    def halves(*shape):
        return mixed(rng.integers(0, 1 << 62, size=shape, dtype=np.int64),
                     sums)

    entries = {k: {"name": k, "route": "cuda",
                   "source": backend.KERNELS[k].source,
                   "replaces": backend.KERNELS[k].replaces,
                   "max_abs_err": 0, "library_ms": None, "per_shape": []}
               for k in FIELD_KERNELS}
    for label, record, op, run, plain, xs, muls in _field_cases(
            device, raw, halves):
        want, plain_ms = _timed_ms(lambda: plain(*xs))
        got = run(*xs)
        pairs = ([(got.c0, want.c0), (got.c1, want.c1)]
                 if record == "field_ext" else [(got, want)])
        err = max(_max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"field: {label} disagrees with the plain "
                                 f"version (max abs err {err})")
        before = backend.KERNELS[record].launches
        run(*xs)
        if backend.KERNELS[record].launches - before != 1:
            raise AssertionError(f"field: {label} launched "
                                 f"{backend.KERNELS[record].launches - before}"
                                 f" {record} kernels")
        out = pairs[0][0]
        limbs = len(pairs)
        nbytes = 8 * (sum(t.numel() for t in xs if t.is_cuda)
                      + limbs * out.numel())
        imads = IMAD_PER_FIELD_MUL * muls * out.numel()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = imads / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms = _device_ms(lambda: run(*xs), 20)
        log(f"field {label}: max_abs_err 0, device {ms:.5f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}), x bound {ms / bound_ms:.2f}, "
            f"plain {plain_ms:.4f} ms")
        entries[record]["per_shape"].append({
            "shape": label, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by})
        del want, got, pairs, out
    a, b = raw(64), raw(64)
    u, v = GF2(raw(64), raw(64)), GF2(raw(64), raw(64))
    calls = {"mul": (lambda: gl.mul(a, b), lambda: gl.mul_plain(a, b)),
             "add": (lambda: gl.add(a, b), lambda: gl.add_plain(a, b)),
             "sub": (lambda: gl.sub(a, b), lambda: gl.sub_plain(a, b)),
             "inverse": (lambda: gl.inverse(a),
                         lambda: gl.exp_plain(a, P - 2)),
             "ext mul": (lambda: u * v, lambda: ext.mul_plain(u, v))}
    per_op = {}
    for name, (kernel, plain) in calls.items():
        per_op[name] = {
            "host_us": _host_us(kernel), "kernels": _cuda_kernels(kernel),
            "plain_host_us": _host_us(plain, 20 if name == "inverse" else
                                      200),
            "plain_kernels": _cuda_kernels(plain)}
        log(f"field {name} on [64]: host {per_op[name]['host_us']:.1f} us "
            f"and {per_op[name]['kernels']} kernel(s) a call; plain "
            f"{per_op[name]['plain_host_us']:.1f} us and "
            f"{per_op[name]['plain_kernels']} kernels")
    for e in entries.values():
        largest = max(e["per_shape"], key=lambda r: r["bound_ms"])
        e.update({"shape": largest["shape"], "ms": largest["ms"],
                  "plain_ms": largest["plain_ms"],
                  "bound_ms": largest["bound_ms"],
                  "bound_by": largest["bound_by"]})
    entries["field"]["per_op"] = per_op
    return list(entries.values())


@phase("kernels vs plain")
def kernels_vs_plain(device, runs, clock_mhz):
    """runs: {phase: (launches, shapes, warm shapes)} of the main path's
    phases."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl

    rng = np.random.default_rng(7)

    def rand(*shape):
        return gl.from_u64(rng.integers(0, gl.ORDER, size=shape,
                                        dtype=np.uint64), device)

    table = []
    for kern in backend.KERNELS.values():
        if kern.name in FIELD_KERNELS:
            continue          # the `field` phase holds them
        launches = sum(r[0][kern.name] for r in runs.values())
        shapes = {}
        for r in runs.values():
            for shape, n in r[1][kern.name].items():
                shapes[shape] = shapes.get(shape, 0) + n
        held = list(shapes) + [s for s in EXTRA_SHAPES.get(kern.name, ())
                               if s not in shapes]
        worst, largest, per_shape, dev_ms = 0, None, [], {}
        for shape in held:
            run, plain, size, pick, sample = _cases(kern.name, shape, rand,
                                                    rng)
            want, plain_ms = _timed_ms(plain)
            err = _max_abs_err(pick(run()), want)
            del want
            worst = max(worst, err)
            before = kern.launches
            run()
            per_call = kern.launches - before
            if per_call < 1:
                raise AssertionError(f"{kern.name} {shape}: the wrapper "
                                     f"launched no kernel")
            small = size < 1 << 16
            ms = _device_ms(run, 100 if small else 10)
            wrap_ms = _wrapper_ms(run, 100 if small else 10)
            bound_ms, bound_by = _bound(kern.name, shape, clock_mhz)
            dev_ms[shape] = (ms, per_call)
            held_on = f" on {sample}" if sample else ""
            log(f"{kern.name} {shape}: max_abs_err {err}{held_on}, device "
                f"{ms:.5f} ms ({per_call} launches a call), wrapper "
                f"{wrap_ms:.5f} ms, plain{held_on} {plain_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by}), launched "
                f"{shapes.get(shape, 0)}")
            per_shape.append({"shape": list(shape), "sample": sample,
                              "launches": shapes.get(shape, 0),
                              "launches_per_call": per_call, "ms": ms,
                              "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms})
            if largest is None or size > largest[0]:
                largest = (size, shape, ms, wrap_ms, plain_ms, bound_ms,
                           bound_by)
        if worst:
            raise AssertionError(f"{kern.name} disagrees with its plain "
                                 f"version (max abs err {worst})")
        # device ms per warm prove: each shape's launches in that prove
        # times its device ms per launch
        warm_ms, warm_calls = {}, {}
        for phase_name, (_, _, warm) in runs.items():
            if warm[kern.name]:
                warm_ms[phase_name] = sum(
                    n / dev_ms[shape][1] * dev_ms[shape][0]
                    for shape, n in warm[kern.name].items())
                warm_calls[phase_name] = sum(
                    n / dev_ms[shape][1]
                    for shape, n in warm[kern.name].items())
        log(f"{kern.name}: calls per warm prove {warm_calls}, device ms per"
            f" warm prove {warm_ms}")
        _, shape, ms, wrap_ms, plain_ms, bound_ms, bound_by = largest
        entry = {"name": kern.name, "route": "cuda", "source": kern.source,
                 "replaces": kern.replaces, "launches": launches,
                 "max_abs_err": worst, "shape": list(shape), "ms": ms,
                 "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 # no single PyTorch call computes a Goldilocks NTT, a
                 # Poseidon/Poseidon2 permutation, sponge or Merkle tree
                 "library_ms": None, "warm_prove_ms": warm_ms,
                 "warm_prove_calls": warm_calls,
                 "per_shape": per_shape}
        if kern.name == "poseidon_permute":
            # K4 (v1) and K5 (v2) are tilings of K2's permutation on the
            # TPU; this kernel takes any batch and serves all three
            entry["replaces"] = ("plonky2_tpu/ops/pallas_poseidon.py:335 "
                                 "(K2), :77 (K4), :372 (K5)")
            entry["held_below_512"] = [list(s) for s in held if s[0] < 512]
        table.append(entry)
    return table


# K1's rows past the 2^19 points of one column round: (batch, lg_n, rate,
# direction, shift), as the prover's calls record them
K1_LARGE = [(1, 17, 3, "forward", 7), (2, 20, 0, "inverse", None),
            (2, 20, 0, "inverse", 7), (1, 21, 3, "forward", 7),
            (1, 24, 0, "inverse", None)]


@phase("K1 past 2^19")
def k1_past_2_19(device, table, clock_mhz):
    """K1 on rows of 2^20 and 2^24 points (two column rounds) against its
    plain version over full outputs; raises K1's max_abs_err in `table`
    and records each call's device ms and launches there."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl

    rng = np.random.default_rng(19)
    entry = next(e for e in table if e["name"] == "ntt")
    entry["past_2_19"] = []
    kern = backend.KERNELS["ntt"]
    for shape in K1_LARGE:
        x = gl.from_u64(rng.integers(0, P, size=(shape[0], 1 << shape[1]),
                                     dtype=np.uint64), device)
        run, plain, _, _, _ = _cases("ntt", shape, lambda *_: x, rng)
        want, plain_ms = _timed_ms(plain)
        err = _max_abs_err(run(), want)
        del want
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if err:
            raise AssertionError(f"ntt {shape} disagrees with its plain "
                                 f"version ({err})")
        before = kern.launches
        run()
        per_call = kern.launches - before
        ms = _device_ms(run, 5)
        bound_ms, bound_by = _bound("ntt", shape, clock_mhz)
        log(f"ntt {shape}: max_abs_err 0, device {ms:.5f} ms ({per_call} "
            f"launches a call), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        entry["past_2_19"].append({"shape": list(shape),
                                   "launches_per_call": per_call, "ms": ms,
                                   "plain_ms": plain_ms,
                                   "bound_ms": bound_ms})
        del x
        torch.cuda.empty_cache()


# p - 1 = 2^64 - 2^32 is the largest canonical value; p, p + 1 and
# 2^64 - 1 are not canonical
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, P, P + 1, (1 << 64) - 1]


@phase("edge batches")
def edge_batches(device, table):
    """K2 and K6 (both entries each), K3 and K7 on edge values, and K1 (both
    entries) on canonical edge values, against their plain versions; raises
    their max_abs_err in `table`."""
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash import poseidon as ps
    from plonky2_tpu_torch.hash import poseidon2 as ps2
    from plonky2_tpu_torch.ops import ntt

    rng = np.random.default_rng(13)

    def batch(*shape):
        """Half random, half edge values (non-canonical ones included)."""
        x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        pick = rng.random(shape) < 0.5
        x[pick] = np.asarray(EDGE, dtype=np.uint64)[
            rng.integers(0, len(EDGE), size=int(pick.sum()))]
        return torch.from_numpy(x.view(np.int64)).to(device)

    full = lambda *shape: gl.const(P - 1, device, shape)
    # every word 2^64 - 1, as an int64 bit pattern (gl.const would reduce it)
    ones = lambda *shape: torch.full(shape, -1, dtype=torch.int64,
                                     device=device)
    # {kernel: (its wrapper, its plain version, inputs)}
    checks = {}
    for prefix, mod in (("poseidon", ps), ("poseidon2", ps2)):
        checks[f"{prefix}_permute"] = (
            mod.permute, mod.permute_plain,
            [batch(4096, 12), full(512, 12), ones(512, 12)])
        checks[f"{prefix}_hash_leaves"] = (
            mod.hash_leaves, mod.hash_leaves_plain,
            [batch(135, 4096), full(135, 4096), full(20, 1 << 17),
             batch(32, 1 << 9)])
        checks[f"{prefix}_merkle_tree"] = (
            functools.partial(mod.merkle_layers, cap_height=4),
            functools.partial(mod.merkle_layers_plain, cap_height=4),
            [batch(1 << 13, 4), full(1 << 9, 4), ones(1 << 9, 4)])
    # K1: canonical edge values (0, 1, p - 1, 2^32 - 1, 2^32) mixed with
    # random ones, and rows of all p - 1, on rows of 2^14, 2^17 and 2^20
    canon = np.asarray([0, 1, P - 1, (1 << 32) - 1, 1 << 32], dtype=np.uint64)

    def canonical_batch(*shape):
        x = rng.integers(0, P, size=shape, dtype=np.uint64)
        pick = rng.random(shape) < 0.5
        x[pick] = canon[rng.integers(0, len(canon), size=int(pick.sum()))]
        return torch.from_numpy(x.view(np.int64)).to(device)

    def k1(forward, inverse):
        """Rows of 2^14: forward at rate 0 without and with a shift, the
        LDE to 2^17, inverse without and with a shift; rows of 2^17: the
        coset inverse and the LDE to 2^20; rows of 2^20: the LDE to 2^23,
        the inverse and the coset inverse (the calls past 2^19 points run
        two column rounds)."""
        def calls(x):
            if x.shape[-1] == 1 << 17:
                return [inverse(x, 7).reshape(-1),
                        forward(x, 3, 7).reshape(-1)]
            if x.shape[-1] == 1 << 20:
                return [y.reshape(-1) for y in (
                    forward(x, 3, 7), inverse(x, None), inverse(x, 7))]
            return [y.reshape(-1) for y in (
                forward(x, 0, None), forward(x, 0, 7), forward(x, 3, 7),
                inverse(x, None), inverse(x, 7))]
        return calls

    checks["ntt"] = (
        k1(ntt.forward, ntt.inverse), k1(ntt.forward_plain, ntt.inverse_plain),
        [canonical_batch(135, 1 << 14), full(4, 1 << 14),
         canonical_batch(2, 1 << 17), full(2, 1 << 17),
         canonical_batch(1, 1 << 20), full(1, 1 << 20)])
    by_name = {e["name"]: e for e in table}
    for name, (run, plain, cases) in checks.items():
        for x in cases:
            err = _max_abs_err(run(x), plain(x))
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                               err)
            if err:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on an edge batch of shape "
                                     f"{tuple(x.shape)} ({err})")
        log(f"{name}: {len(cases)} edge batches bit-exact")


@phase("PoW stress")
def pow_stress(device):
    """One 2^19 wave of K2 and of K6 against the host C permutation over its
    full output, then waves from the fib transcript states and from random
    sponge states, at 16 bits and at 0, 1, 2 and 8, each witness checked
    on the host."""
    from plonky2_tpu_torch import host
    from plonky2_tpu_torch.fri.prover import _pow_wave
    from plonky2_tpu_torch.hash.hashers import POSEIDON, POSEIDON2

    if host.load() is None:
        raise AssertionError("no host C permutation library")
    rng = np.random.default_rng(17)
    batch, bits = 1 << 19, 16
    for hasher in (POSEIDON, POSEIDON2):
        base = rng.integers(0, P, size=12, dtype=np.uint64)
        states = np.tile(base, (batch, 1))
        states[:, 3] = np.arange(batch, dtype=np.uint64)
        got = hasher.permute(torch.from_numpy(states.view(np.int64))
                             .to(device))
        want = hasher.permute_many_host(states)
        if not np.array_equal(got.cpu().numpy().view(np.uint64), want):
            raise AssertionError(f"a 2^19 {hasher.name} wave differs from "
                                 f"the host permutation")
        log(f"PoW stress: a {batch}-state {hasher.name} wave equals the host "
            f"permutation")

    # (hasher, state, witness position, bits, whether every smaller
    # candidate is checked on the host too)
    waves = [(h, state, pos, b, True) for _, state, pos, b in POW_STATES
             for h in (POSEIDON, POSEIDON2)]
    for hasher, count in ((POSEIDON, 48), (POSEIDON2, 24)):
        waves += [(hasher, [int(v) for v in rng.integers(0, P, size=12,
                                                         dtype=np.uint64)],
                   int(rng.integers(0, 8)), bits, i < 8)
                  for i in range(count)]
    # the fewest bits: at 0 every candidate meets the bound, so the wave
    # returns 0 without a test against 2^64
    few = (0, 1, 2, 8)
    waves += [(hasher, [int(v) for v in rng.integers(0, P, size=12,
                                                     dtype=np.uint64)],
               int(rng.integers(0, 8)), b, True)
              for hasher in (POSEIDON, POSEIDON2) for b in few]
    host_perms = 0
    for hasher, state, pos, wave_bits, smallest in waves:
        w = _pow_wave(hasher.permute, state, pos, wave_bits, batch, device)
        lo = 0 if smallest else w
        cand = np.tile(np.asarray(state, dtype=np.uint64), (w + 1 - lo, 1))
        cand[:, pos] = np.arange(lo, w + 1, dtype=np.uint64)
        resp = hasher.permute_many_host(cand)[:, 7]
        host_perms += w + 1 - lo
        thr = np.uint64(1 << (64 - wave_bits)) if wave_bits else None
        if not (w == 0 if thr is None else (
                resp[-1] < thr and bool(np.all(resp[:-1] >= thr)))):
            raise AssertionError(f"{hasher.name} wave from {state} (witness "
                                 f"position {pos}) returned {w}, which is "
                                 f"not the smallest witness on the host")
    log(f"PoW stress: {len(waves)} waves ({len(POW_STATES)} transcript "
        f"states through both hashers, 48 random through poseidon and 24 "
        f"through poseidon2 at {bits} bits, one random through each at "
        f"{few} bits), every witness meets the bound on the host, and"
        f" {sum(w[4] for w in waves)} are the host's smallest ({host_perms} "
        f"host permutations)")


# ---------------------------------------------------------------------------
# The multi-device prover on a one-rank mesh, the four-step LDE past K1's
# 2^24 points, mutable trees, context reports and the circom verifier
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _nccl_world(device):
    """A one-rank NCCL process group on `device` for the phase inside, on
    a free localhost port; destroyed after it. NCCL takes one rank a card,
    so the collectives between ranks are tested on CPU ranks over gloo."""
    import socket

    import torch.distributed as dist
    from plonky2_tpu_torch.parallel.multihost import init_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(device)
    init_multihost(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _kernel_shapes() -> dict:
    from plonky2_tpu_torch import backend
    return {k.name: dict(k.shapes) for k in backend.KERNELS.values()}


def _read_counts(name: str, kernels: tuple, before_last: dict):
    """(launches, shapes, shapes of the last call) after a phase's main
    path; fails if a kernel of `kernels` never launched."""
    from plonky2_tpu_torch import backend
    launches = {k.name: k.launches for k in backend.KERNELS.values()}
    shapes = _kernel_shapes()
    last = {k: {s: n - before_last[k].get(s, 0) for s, n in v.items()
                if n > before_last[k].get(s, 0)} for k, v in shapes.items()}
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched by the main "
                             f"path: {missing}")
    log(f"{name}: launches {launches}")
    return launches, shapes, last


def _timed_s(device, fn):
    """(output, seconds, peak allocated bytes) of one call."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(device))


@phase("mesh-prove")
def mesh_prove(device, dummy, stark, stark_proof):
    """The dummy-2^14 circuit of phase 5 and the starky-fib system proved
    twice serially and twice under prover_mesh(make_mesh()) on a one-rank
    NCCL mesh, all byte-equal (the builder's random stream rewound before
    each PLONK prove; the STARK proofs pickled, and equal to starky-fib's
    proof); cold and warm seconds and peak memory of both ways; and
    commit_sharded_2d on a (1, 1) mesh at [135, 2^14], rate 3, cap 4,
    against commit_batch. The counts cover the 2-D commit and the mesh
    proves; the last call is a warm dummy-2^14 prove."""
    import pickle

    from torch.distributed.device_mesh import init_device_mesh

    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.fri.oracle import commit_batch
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    from plonky2_tpu_torch.parallel import sharding
    from plonky2_tpu_torch.recursion.dummy import dummy_witness
    from plonky2_tpu_torch.starky.prover import prove as stark_prove
    from plonky2_tpu_torch.starky.verifier import verify_stark_proof
    import stark_circuits as circuits

    witness = dummy_witness(dummy.prover_only.public_inputs, {0: 42})
    rng = _builder_rng(dummy)
    start = copy.deepcopy(rng.bit_generator.state)

    def prove_dummy():
        rng.bit_generator.state = copy.deepcopy(start)
        return dummy.prove(witness)

    config = _stark_config()
    _, trace, pis = circuits.fibonacci(PORT, STARK_ROWS)
    # the 2-D commit's reference, kept on the host
    coeffs = gl.from_u64(np.random.default_rng(23).integers(
        0, P, size=(135, 1 << 14), dtype=np.uint64), device)
    tree = commit_batch(coeffs.unsqueeze(1), 3, 4,
                        POSEIDON).batches[0].merkle_tree
    want = (tree.leaves_host(), [gl.to_u64(x) for x in tree.layers])
    del tree

    def prove_stark():
        return stark_prove(stark, config, trace, pis, device=device)
    serial = {"dummy-2^14": [_timed_s(device, prove_dummy)
                             for _ in range(2)],
              "starky-fib": [_timed_s(device, prove_stark)
                             for _ in range(2)]}
    with _nccl_world(device):
        mesh = sharding.make_mesh()
        log(f"mesh-prove: {mesh}, backend "
            f"{torch.distributed.get_backend()}")
        torch.cuda.synchronize(device)
        backend.reset_counts()
        mesh2d = init_device_mesh("cuda", (1, 1),
                                  mesh_dim_names=("col", "x"))
        # the group's first collectives: the communicator starts here
        (leaves, layers), t_2d, _ = _timed_s(
            device, lambda: sharding.commit_sharded_2d(mesh2d, coeffs, 3, 4))
        same = (np.array_equal(gl.to_u64(leaves), want[0])
                and len(layers) == len(want[1])
                and all(np.array_equal(gl.to_u64(a), b)
                        for a, b in zip(layers, want[1])))
        del leaves, layers     # out of the proves' peak memory
        meshed = {}
        with sharding.prover_mesh(mesh):
            meshed["starky-fib"] = [_timed_s(device, prove_stark)
                                    for _ in range(2)]
            meshed["dummy-2^14"] = [_timed_s(device, prove_dummy)]
            before = _kernel_shapes()     # the last call: a warm prove
            meshed["dummy-2^14"].append(_timed_s(device, prove_dummy))
        run = _read_counts("mesh-prove", POSEIDON_PATH, before)
    if not same:
        raise AssertionError("mesh-prove: commit_sharded_2d on the (1, 1) "
                             "mesh differs from commit_batch")
    log(f"mesh-prove: commit_sharded_2d [135, 2^14], rate 3, cap 4, on the "
        f"(1, 1) mesh equals commit_batch (leaves and every layer); "
        f"{t_2d:.3f} s with the communicator's start")
    as_bytes = {"dummy-2^14": lambda p: _proof_bytes(dummy, p),
                "starky-fib": pickle.dumps}
    if pickle.dumps(serial["starky-fib"][0][0]) != pickle.dumps(stark_proof):
        raise AssertionError("mesh-prove: starky-fib's proof is not "
                             "reproducible")
    for name in serial:
        got = [as_bytes[name](p) for p, _, _ in serial[name] + meshed[name]]
        if any(b != got[0] for b in got):
            raise AssertionError(f"mesh-prove: {name} under the mesh "
                                 f"differs from its serial proof")
        (_, s_cold, _), (_, s_warm, s_peak) = serial[name]
        (_, m_cold, _), (_, m_warm, m_peak) = meshed[name]
        log(f"mesh-prove: {name} under the one-rank mesh equals its serial "
            f"proof byte for byte; serial {s_cold:.3f} then {s_warm:.3f} s, "
            f"peak {s_peak / 2**20:.1f} MiB; mesh {m_cold:.3f} then "
            f"{m_warm:.3f} s, peak {m_peak / 2**20:.1f} MiB; warm mesh / "
            f"serial {m_warm / s_warm:.3f}")
    verify_stark_proof(stark, meshed["starky-fib"][-1][0], config)
    dummy.verify(meshed["dummy-2^14"][-1][0])
    return run


def _direct_eval(coeffs: torch.Tensor, points: list) -> list:
    """P(x) = sum_j c_j x^j for each host point x, exactly on the card:
    x^j = (x^4096)^(j >> 12) x^(j & 4095) from two power tables, one
    elementwise product with the coefficients and a sum of 32-bit halves
    (`goldilocks.reduce_sum`, exact up to 2^30 terms)."""
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field import reference as fref

    n = coeffs.shape[0]
    lo = 4096
    hi = n // lo
    out = []
    for x in points:
        pw = gl.mul(gl.powers(fref.exp(x, lo), hi, coeffs.device)
                    .unsqueeze(1),
                    gl.powers(x, lo, coeffs.device).unsqueeze(0))
        out.append(int(gl.to_u64(gl.reduce_sum(gl.mul(coeffs,
                                                      pw.reshape(-1)))))
                   % P)
    return out


@phase("four-step-lde")
def four_step_lde(device):
    """coset_lde_large of one polynomial of 2^24 coefficients at rate 3 (2^27
    points, past K1's 2^24) on a one-rank NCCL mesh, cold and warm, held at
    64 seeded points against direct evaluation; its steps timed (K1 passes,
    plain multiplies, exchanges); then 2^21 -> 2^24 held over its whole
    output against K1's direct coset LDE and against forward_plain."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field import reference as fref
    from plonky2_tpu_torch.ops import ntt
    from plonky2_tpu_torch.parallel import ntt_sharded, sharding
    from plonky2_tpu_torch.utils.timing import TimingTree

    rng = np.random.default_rng(29)
    big = gl.from_u64(rng.integers(0, P, size=1 << 24, dtype=np.uint64),
                      device)
    small = gl.from_u64(rng.integers(0, P, size=1 << 21, dtype=np.uint64),
                        device)
    with _nccl_world(device):
        mesh = sharding.make_mesh()
        torch.cuda.synchronize(device)
        backend.reset_counts()
        got_small = ntt_sharded.coset_lde_large(small, mesh, 3).to_local()
        timings, results = [], []
        for _ in range(2):
            before = _kernel_shapes()
            timing = TimingTree("four-step", enabled=True)
            out, seconds, peak = _timed_s(device, lambda: (
                ntt_sharded.coset_lde_large(big, mesh, 3, timing=timing)
                .to_local()))
            timings.append((seconds, peak, timing.seconds()))
            results.append(out)
            del out
        run = _read_counts("four-step-lde", ("ntt", "field"), before)
    out = results[-1]
    if not torch.equal(results[0], out):
        raise AssertionError("four-step-lde: two runs differ")
    del results
    N = 1 << 27
    idx = np.sort(rng.choice(N, 64, replace=False))
    w = fref.primitive_root_of_unity(27)
    g = fref.MULTIPLICATIVE_GROUP_GENERATOR
    want = _direct_eval(big, [fref.mul(g, fref.exp(w, int(i))) for i in idx])
    got = [int(v) for v in gl.to_u64(out[torch.as_tensor(idx,
                                                         device=device)])]
    if got != want:
        raise AssertionError("four-step-lde: 2^27 points differ from "
                             "direct evaluation")
    log("four-step-lde: 2^24 -> 2^27 equals direct evaluation at 64 seeded "
        "points")
    for i, (seconds, peak, steps) in enumerate(timings):
        k1 = steps["step 1: K1"] + steps["step 4: K1"]
        plain = steps["row factor"] + steps["middle twiddles"]
        xchg = steps["exchange 1"] + steps["exchange 2"]
        log(f"four-step-lde: {'cold' if i == 0 else 'warm'} 2^24 -> 2^27 "
            f"{seconds:.3f} s, peak {peak / 2**20:.1f} MiB; K1 passes "
            f"{k1:.4f} s ({k1 / seconds:.1%}), plain multiplies {plain:.4f} "
            f"s ({plain / seconds:.1%}), exchanges {xchg:.4f} s "
            f"({xchg / seconds:.1%}); steps "
            f"{ {k: round(v, 4) for k, v in steps.items()} }")
    del out
    direct = ntt.coset_lde(small.unsqueeze(0), 3)[0]
    plain = ntt.forward_plain(small.unsqueeze(0), 3,
                              fref.MULTIPLICATIVE_GROUP_GENERATOR)[0]
    if not (torch.equal(got_small, direct) and torch.equal(direct, plain)):
        raise AssertionError("four-step-lde: 2^21 -> 2^24 differs from K1's "
                             "direct LDE or from forward_plain")
    log("four-step-lde: 2^21 -> 2^24 equals K1's direct coset LDE and "
        "forward_plain over all 2^24 points")
    torch.cuda.empty_cache()
    return run


@phase("merkle-update")
def merkle_update(device):
    """A 2^17-leaf tree of 135-element leaves at cap 4 (Poseidon): one leaf
    changed, then 200 leaves across a cap subtree's boundary; after each,
    every layer equals a fresh build; update and rebuild ms."""
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.hash.hashers import POSEIDON
    from plonky2_tpu_torch.hash.merkle import MerkleTree

    rng = np.random.default_rng(31)
    n, width, cap = 1 << 17, 135, 4

    def rand(*shape):
        return gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64),
                           device)
    tree = MerkleTree(rand(n, width), cap, POSEIDON)
    from plonky2_tpu_torch import backend
    torch.cuda.synchronize(device)
    backend.reset_counts()
    edits = [(12345, 12346), (n // 16 - 100, n // 16 + 100)]
    times, before = [], None
    for start, end in edits:
        new = rand(end - start, width)
        before = _kernel_shapes()
        _, t_update, _ = _timed_s(device, lambda: (
            tree.change_leaf_and_update(new[0], start) if end - start == 1
            else tree.change_leaves_in_range_and_update(new, start, end)))
        times.append(t_update)
    run = _read_counts("merkle-update", ("poseidon_permute",
                                         "poseidon_hash_leaves"), before)
    fresh, t_build, _ = _timed_s(
        device, lambda: MerkleTree(tree.leaves.clone(), cap, POSEIDON))
    if len(fresh.layers) != len(tree.layers) or not all(
            torch.equal(a, b) for a, b in zip(tree.layers, fresh.layers)):
        raise AssertionError("merkle-update: an updated tree differs from "
                             "a fresh build")
    log(f"merkle-update: 2^17 x 135 leaves, cap 4: one leaf "
        f"{times[0] * 1e3:.3f} ms, 200 leaves across a subtree boundary "
        f"{times[1] * 1e3:.3f} ms, rebuild {t_build * 1e3:.3f} ms; every "
        f"layer equals the rebuild's")
    return run


@phase("context and circom")
def context_circom(device, fib):
    """On the host: print_gate_counts of the fib100-wrap's builder, and the
    exported vanishing verifier (utils/circom_export.py) evaluated on the
    card's fib100 proof: accepted, and a tampered wire opening rejected."""
    from plonky2_tpu_torch.field import reference as fref
    from plonky2_tpu_torch.plonk.get_challenges import get_challenges
    from plonky2_tpu_torch.recursion.verifier import wrap_circuit
    from plonky2_tpu_torch.utils import circom_export as circom

    data, proof = fib
    builder, _ = wrap_circuit(data)
    report = builder.print_gate_counts()
    if "instances of" not in report:
        raise AssertionError("context and circom: an empty gate report")
    common = data.common
    pi_hash = common.gc.hash_public_inputs(proof.public_inputs)
    ch = get_challenges(proof, pi_hash, data.verifier_only.circuit_digest,
                        common)
    zeta = tuple(ch.plonk_zeta)
    zeta_n = fref.ext2_exp(zeta, common.degree)
    z_h = fref.ext2_sub(zeta_n, (1, 0))
    l0 = fref.ext2_mul(z_h, fref.ext2_inverse(fref.ext2_scalar_mul(
        fref.ext2_sub(zeta, (1, 0)), common.degree % P)))
    t0 = time.perf_counter()
    code = circom.export_vanishing_verifier_circom(common)
    t_export = time.perf_counter() - t0
    o = proof.proof.openings
    qdf = common.quotient_degree_factor

    def accepts(wires):
        outs = circom.evaluate_circom_program(code, {
            "zeta": zeta, "l0": l0,
            "constants": [tuple(v) for v in o.constants], "wires": wires,
            "plonk_zs": [tuple(v) for v in o.plonk_zs],
            "plonk_zs_next": [tuple(v) for v in o.plonk_zs_next],
            "partial_products": [tuple(v) for v in o.partial_products],
            "sigmas": [tuple(v) for v in o.plonk_sigmas],
            "betas": [(b, 0) for b in ch.plonk_betas],
            "gammas": [(g, 0) for g in ch.plonk_gammas],
            "alphas": [(a, 0) for a in ch.plonk_alphas],
            "public_input_hash": list(pi_hash)})
        for i in range(common.config.num_challenges):
            acc = (0, 0)
            for cq in reversed(o.quotient_polys[i * qdf:(i + 1) * qdf]):
                acc = fref.ext2_add(fref.ext2_mul(acc, zeta_n), tuple(cq))
            if tuple(outs[i]) != fref.ext2_mul(z_h, acc):
                return False
        return True
    wires = [tuple(v) for v in o.wires]
    if not accepts(wires):
        raise AssertionError("context and circom: the exported verifier "
                             "refused the fib100 proof")
    wires[0] = ((wires[0][0] + 1) % P, wires[0][1])
    if accepts(wires):
        raise AssertionError("context and circom: the exported verifier "
                             "accepted a tampered opening")
    log(f"context and circom: the exported VanishingAtZeta ({len(code)} "
        f"bytes, {code.count('<==')} assignments, exported in "
        f"{t_export:.3f} s) accepts the fib100 proof and rejects a tampered"
        f" wire opening")


# the JAX examples' value lines (examples/*.py), by example: what the
# port's example must print; "{}" is filled with the proof's byte count
P_FIB100 = functools.reduce(lambda ab, _: (ab[1], (ab[0] + ab[1]) % P),
                            range(99), (0, 1))[1]
EXAMPLE_LINES = {
    "fibonacci": [f"100th Fibonacci number (mod p): {P_FIB100}",
                  "proof verified"],
    "factorial": [f"100! (mod p): {math.factorial(100) % P}",
                  "proof verified"],
    "range_check": ["value 42 is in [0, 2^6)", "proof verified"],
    "square_root": [f"proved knowledge of sqrt({8846460 ** 2 % P})",
                    "serialization roundtrip OK ({} bytes)"],
}


def _example(name: str, argv: list):
    """plonky2_tpu_torch.examples.<name>.main(argv) with its printed lines
    captured and logged: (its return value, its lines, {kernel: launches}
    of the run)."""
    import importlib
    import io
    from plonky2_tpu_torch import backend

    module = importlib.import_module(f"plonky2_tpu_torch.examples.{name}")
    before = {k.name: k.launches for k in backend.KERNELS.values()}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        made = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k.name: k.launches - before[k.name]
                for k in backend.KERNELS.values()}
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"examples: {name}: | {line}")
    missing = [k for k in POSEIDON_PATH if launched[k] == 0]
    if missing:
        raise AssertionError(f"examples: {name} never launched {missing}")
    log(f"examples: {' '.join([name] + argv)}: {seconds:.3f} s, launches "
        f"{ {k: n for k, n in launched.items() if n} }")
    return made, lines


@phase("examples")
def examples(device):
    """The seven entry points of plonky2_tpu_torch/examples at their default
    sizes on the card (--seed 1234 for reproducible bytes): each prints the
    JAX example's values and launches K1-K3; fibonacci's transcript equals
    tests/golden/fib100_transcript.json, factorial's, range_check's and
    square_root's bytes equal tests/golden/example_<name>.bin (the JAX
    package's proofs, scripts/jax_examples_golden.py); the reloaded circuit
    of fibonacci_serialization proves the original's bytes; batch_prove's
    four proofs equal serial proves; bench_recursion's 2^12 inner proof and
    its wrap verify. The counts cover the seven runs alone: the checks'
    own proves come after they are read."""
    from plonky2_tpu_torch import backend
    from plonky2_tpu_torch.examples._common import fib_circuit
    from plonky2_tpu_torch.examples.batch_prove import witnesses

    seed = ["--seed", "1234"]
    names = list(EXAMPLE_LINES) + ["fibonacci_serialization", "batch_prove"]
    torch.cuda.synchronize(device)
    backend.reset_counts()
    made = {name: _example(name, seed) for name in names}
    before = _kernel_shapes()
    made["bench_recursion"] = _example("bench_recursion", [])
    run = _read_counts("examples", POSEIDON_PATH, before)
    # the checks below prove again: after the counts are read
    for name, want in EXAMPLE_LINES.items():
        (data, proof), lines = made[name]
        raw = _proof_bytes(data, proof)
        if lines != [line.format(len(raw)) for line in want]:
            raise AssertionError(f"examples: {name} printed {lines}, the "
                                 f"JAX example {want}")
        if name == "fibonacci":
            _golden("examples: fibonacci", data, proof,
                    os.path.join(GOLDEN_DIR, "fib100_transcript.json"))
            continue
        with open(os.path.join(GOLDEN_DIR, f"example_{name}.bin"),
                  "rb") as f:
            if raw != f.read():
                raise AssertionError(f"examples: {name}'s proof differs "
                                     f"from the JAX package's")
        log(f"examples: {name}: {len(raw)} proof bytes equal the JAX "
            f"package's (degree 2^{data.common.degree_bits})")
    (data, restored, pw, proof), lines = made["fibonacci_serialization"]
    if lines[1:] != EXAMPLE_LINES["fibonacci"][:1] + [
            "proof from reloaded circuit verified"]:
        raise AssertionError(f"examples: fibonacci_serialization printed "
                             f"{lines}")
    if _proof_bytes(restored, proof) != _proof_bytes(data, data.prove(pw)):
        raise AssertionError("examples: the reloaded circuit's proof "
                             "differs from the original's")
    log("examples: fibonacci_serialization: the reloaded circuit proves "
        "the original's bytes")
    (data, proofs), lines = made["batch_prove"]
    if lines[2] != f"fib(100) for (a=0,b=1): {P_FIB100}":
        raise AssertionError(f"examples: batch_prove printed {lines}")
    builder, a, b, _ = fib_circuit(1234)
    serial = builder.build(device=device)
    if [_proof_bytes(data, p) for p in proofs] != [
            _proof_bytes(serial, serial.prove(w))
            for w in witnesses(a, b, len(proofs))]:
        raise AssertionError("examples: batch_prove's proofs differ from "
                             "serial proves")
    log(f"examples: batch_prove: B = {len(proofs)} proofs equal serial "
        f"proves")
    (inner, _, outer, wrap_proof), lines = made["bench_recursion"]
    if lines[-1] != "wrap verified; public inputs [42, 0, 0, 0]" or \
            inner.common.degree_bits != 12:
        raise AssertionError(f"examples: bench_recursion printed {lines}")
    del made
    torch.cuda.empty_cache()
    return run


def _share_line(name: str, timing, total: float) -> None:
    """Each top-level scope's seconds and share of a prove of `total`
    seconds, and the time outside the scopes."""
    scoped = [(label, dt) for depth, label, dt in timing.records
              if depth == 0]
    rest = total - sum(dt for _, dt in scoped)
    log(f"scopes: {name}: prove {total:.4f} s = "
        + "; ".join(f"{label} {dt:.4f} s {dt / total:.1%}"
                    for label, dt in scoped)
        + f"; outside the scopes {rest:.4f} s {rest / total:.1%}")


@phase("scopes")
def scopes(device, dummy, wrap):
    """One warm prove of dummy-2^14 and of the fib100-wrap, and one warm
    prove_batch of four dummy witnesses, each under an enabled TimingTree
    whose scopes end in a synchronize: every scope's seconds and share of
    the prove, the labels in the JAX package's order (the port's
    HOST_SPANS between them). Before and after the
    first, dummy-2^14 proved warm by default (a disabled tree): the seconds
    and hand-kernel launches of both ways."""
    from plonky2_tpu_torch.plonk.batch_prover import BATCH_SCOPES, prove_batch
    from plonky2_tpu_torch.plonk.prover import HOST_SPANS, SERIAL_SCOPES
    from plonky2_tpu_torch.recursion.dummy import dummy_witness
    from plonky2_tpu_torch.utils.timing import TimingTree

    pis = dummy.prover_only.public_inputs
    B = 4
    cases = [
        ("dummy-2^14", lambda t: dummy.prove(dummy_witness(pis, {0: 42}), t),
         list(SERIAL_SCOPES)),
        ("fib100-wrap", lambda t: wrap[0].prove(wrap[1]([]), t),
         list(SERIAL_SCOPES)),
        (f"batch-dummy-2^14 B = {B}", lambda t: prove_batch(
            dummy.prover_only, dummy.common,
            [dummy_witness(pis, {0: 42 + i}) for i in range(B)], t),
         list(BATCH_SCOPES[:-1])
         + [BATCH_SCOPES[-1].format(b=b) for b in range(B)])]
    from plonky2_tpu_torch import backend

    def timed(prove, timing):
        torch.cuda.synchronize(device)
        k0 = sum(k.launches for k in backend.KERNELS.values())
        t0 = time.perf_counter()
        prove(timing)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0,
                sum(k.launches for k in backend.KERNELS.values()) - k0)
    # dummy-2^14 by default (a disabled tree) before and after the first
    # case's timed prove: what the scopes' synchronizes cost
    turns = [timed(cases[0][1], None)]
    for name, prove, labels in cases:
        timing = TimingTree(name, enabled=True)
        total, launched = timed(prove, timing)
        got = [label for depth, label, _ in timing.records
               if depth == 0 and label not in HOST_SPANS]
        if got != labels:
            raise AssertionError(f"scopes: {name} recorded {got}")
        _share_line(name, timing, total)
        if prove is cases[0][1]:
            turns += [(total, launched), timed(prove, None)]
    log(f"scopes: dummy-2^14 warm proves in turn default, timed (a "
        f"synchronize at each scope's end), default: "
        f"{', '.join(f'{t:.4f}' for t, _ in turns)} s; hand-kernel "
        f"launches {[n for _, n in turns]}")
    if len({n for _, n in turns}) != 1:
        raise AssertionError("scopes: a timed prove launched other kernels "
                             "than a default one")


def _busy_share(events: list, t0: float, t1: float) -> float:
    """The share of [t0, t1] (trace microseconds) in which the card ran a
    kernel, a copy or a fill (the union of their intervals)."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy, end = 0.0, t0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (t1 - t0)


# the CUDA functions of K1, K2 (both entries) and K3 under Poseidon, as
# the profiler names them (the sources' anonymous namespace included)
_POSEIDON_T = r"<(?:\(anonymous namespace\)::)?Poseidon>"
TRACE_KERNELS = {"K1 ntt": r"\bntt_(row|tiles|columns)\b",
                 "K2 permute": r"\bpermute_kernel" + _POSEIDON_T,
                 "K2 merkle_tree": r"\bmerkle_kernel" + _POSEIDON_T,
                 "K3 hash_leaves": r"\bhash_leaves(_lanes)?_kernel"
                                   + _POSEIDON_T}


@phase("profile")
def profile(device):
    """The fibonacci example (fib(100), seed 1234) under
    PLONKY2_TPU_PROFILE=<a temp directory>: the default TimingTree of its
    prove starts torch.profiler, stop_profiler() writes the Chrome trace,
    which must name all eight scopes and hold events of K1's, K2's and K3's
    CUDA functions; the card's busy share inside the prove's scopes."""
    import re
    import shutil
    import tempfile
    from plonky2_tpu_torch.examples import fibonacci
    from plonky2_tpu_torch.plonk.prover import SERIAL_SCOPES
    from plonky2_tpu_torch.utils.timing import stop_profiler

    out_dir = tempfile.mkdtemp(prefix="plonky2_tpu_profile_")
    os.environ["PLONKY2_TPU_PROFILE"] = out_dir
    try:
        try:
            fibonacci.main(["--seed", "1234"])
        finally:
            path = stop_profiler()
            del os.environ["PLONKY2_TPU_PROFILE"]
        if path is None:
            raise AssertionError("profile: no capture started")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in SERIAL_SCOPES]
    missing = set(SERIAL_SCOPES) - {e["name"] for e in ranges}
    if missing:
        raise AssertionError(f"profile: scopes missing from the trace: "
                             f"{sorted(missing)}")
    on_card = {e["name"] for e in events
               if e.get("cat") == "gpu_user_annotation"}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(1 for e in kernels if re.search(pat, e["name"]))
              for k, pat in TRACE_KERNELS.items()}
    if not all(counts.values()):
        names = sorted({e["name"][:120] for e in kernels})
        raise AssertionError(f"profile: kernels missing from the trace: "
                             f"{counts}; its kernels: {names}")
    t0 = min(e["ts"] for e in ranges)
    t1 = max(e["ts"] + e["dur"] for e in ranges)
    busy = _busy_share(events, t0, t1)
    log(f"profile: trace of {len(events)} events ({size} bytes): all eight "
        f"scopes, {len(on_card & set(SERIAL_SCOPES))} of them as ranges on "
        f"the card's timeline; {len(kernels)} kernel events, hand kernels "
        f"{counts}; the prove's scopes span {(t1 - t0) / 1e3:.3f} ms, the "
        f"card busy {busy:.1%} of it")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from plonky2_tpu_torch import backend

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, max SM clock {clock:.0f} MHz")
    log(f"[build] kernels built/loaded in {backend.build():.3f} s")
    for line in backend.PTXAS_REPORT.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(line.strip())
    field_table = field(device, clock)

    fib = fib100(device)
    runs = {}
    runs["fib100-wrap"], *fib_wrap = fib100_wrap(device, fib)
    fib21_poseidon2(device)
    fib21_keccak(device)
    fib21_poseidon_bn128(device)
    runs["dummy-2^14"], dummy, (dummy_proof, *_) = dummy_2_14(device)
    runs["wrap-1"], wrap, (wrap_proof, *_) = wrap_1(device, dummy,
                                                    dummy_proof)
    runs["wrap-2"] = wrap_2(device, wrap, wrap_proof)[0]
    runs["outer-keccak"], runs["outer-keccak wrap-2"] = outer_keccak(
        device, fib, (wrap, wrap_proof))
    runs["outer-poseidon-bn128"] = outer_poseidon_bn128(device, fib)
    runs["cyclic-ivc"] = cyclic_ivc(device)
    runs["conditional"] = conditional(device)
    runs["dummy-2^14-poseidon2"] = dummy_2_14_poseidon2(device)
    runs["batch-dummy-2^14"] = batch_dummy_2_14(device, dummy)[0]
    scopes(device, dummy, fib_wrap)
    del fib_wrap
    runs["batch-dummy-2^14-poseidon2"] = batch_dummy_2_14_poseidon2(device)
    runs["zk-fib"], zk_data, zk_proof = zk_fib(device)
    compressed(device, [("dummy-2^14", dummy, dummy_proof),
                        ("zk-fib", zk_data, zk_proof)])
    runs["circuit-serialization"] = circuit_serialization(device)
    laid_out = []
    for name, fn in (("schnorr-ecgfp5", schnorr_ecgfp5),
                     ("secp256k1-curve", secp256k1_curve),
                     ("lookups", lookups)):
        runs[name], gates = fn(device)
        laid_out += gates
    gates_on_card(device, laid_out)
    runs["starky-fib"], stark, stark_proof = starky_fib(device)
    runs["starky-wide"] = starky_wide(device)
    runs["starky-logup"] = starky_logup(device)
    runs["starky-ctl"] = starky_ctl(device)
    runs["starky-recursive"] = starky_recursive(device, stark, stark_proof)
    runs["starky-poseidon2"] = starky_poseidon2(device)
    runs["mesh-prove"] = mesh_prove(device, dummy, stark, stark_proof)
    runs["four-step-lde"] = four_step_lde(device)
    runs["merkle-update"] = merkle_update(device)
    context_circom(device, fib)
    runs["examples"] = examples(device)
    profile(device)
    table = kernels_vs_plain(device, runs, clock)
    for entry in field_table:
        entry["launches"] = sum(r[0][entry["name"]] for r in runs.values())
    table += field_table
    k1_past_2_19(device, table, clock)
    edge_batches(device, table)
    pow_stress(device)
    assert sys.modules["jax"] is None and sys.modules["plonky2_tpu"] is None
    log(f"chip_smoke.py: all phases ok in {time.perf_counter() - t_start:.1f}"
        f" s")

    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
