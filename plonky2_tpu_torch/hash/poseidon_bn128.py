"""PoseidonBN128 hasher: the width-12 Goldilocks sponge whose permutation is
a BN254-scalar-field Poseidon on the packed state.

Reference: plonky2/src/hash/poseidon_bn128.rs — the reference outsources the
permutation to a Go static library (polymerdao/go-iden3-crypto
`poseidon-permute-c`, linked by plonky2/build.rs:63-88; the binary is
STRIPPED from the snapshot). The permutation was reconstructed here from the
reference KATs (poseidon_bn128.rs:210-262) and verified bit-exact against
both:

  1. Pack the 12 Goldilocks u64s big-endian into 4 BN254 scalars:
       e_i = x[3i]*2^128 + x[3i+1]*2^64 + x[3i+2]
  2. Run the circomlib-compatible Poseidon permutation at t=5 with the
     capacity element prepended: state = [0, e0, e1, e2, e3]; 8 full + 60
     partial rounds, x^5 S-box; round constants and the Cauchy MDS matrix
     1/(x_i + y_j) generated by the Grain LFSR procedure of the Poseidon
     reference implementation (one continuing stream: constants first, then
     the matrix x/y vectors) — this matches go-iden3-crypto / circomlib's
     generate_parameters_grain.sage parameterization.
  3. Unpack the first 4 output elements big-endian into 12 u64 chunks, each
     reduced by ONE conditional Goldilocks subtraction (the Rust wrapper's
     `if r >= ORDER { r - ORDER }`, poseidon_bn128.rs:80-140).

Purpose (reference README): Merkle caps verifiable cheaply inside a BN254
circom circuit (circomlib's Poseidon template is this exact permutation).
"""

from __future__ import annotations

from functools import lru_cache

# BN254 (alt_bn128) scalar field modulus
P_BN254 = (21888242871839275222246405745257275088548364400416034343698204186575808495617)

T = 5
R_F = 8
R_P = 60


def _grain_bits(field: int, sbox: int, n: int, t: int, r_f: int, r_p: int):
    """Grain LFSR keystream per the Poseidon reference implementation's
    generate_parameters_grain.sage."""
    state = []
    for value, bits in [(field, 2), (sbox, 4), (n, 12), (t, 12),
                        (r_f, 10), (r_p, 10)]:
        state += [int(b) for b in bin(value)[2:].zfill(bits)]
    state += [1] * 30
    assert len(state) == 80

    def update():
        new = (state[62] ^ state[51] ^ state[38] ^ state[23]
               ^ state[13] ^ state[0])
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()

    while True:
        # shrinking: emit bit2 iff bit1 == 1
        b1 = update()
        b2 = update()
        if b1:
            yield b2


def _grain_field_elements(gen, count: int, n_bits: int, p: int):
    out = []
    while len(out) < count:
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | next(gen)
        if v < p:
            out.append(v)
    return out


@lru_cache(maxsize=None)
def _constants():
    """(round_constants [R_F+R_P][T], mds [T][T]). The MDS x/y vectors come
    from the SAME Grain stream, continuing after the round constants (KAT-
    verified against the reference's Go library output)."""
    gen = _grain_bits(1, 0, 254, T, R_F, R_P)
    rc_flat = _grain_field_elements(gen, (R_F + R_P) * T, 254, P_BN254)
    rc = [rc_flat[i * T:(i + 1) * T] for i in range(R_F + R_P)]
    xs = _grain_field_elements(gen, T, 254, P_BN254)
    ys = _grain_field_elements(gen, T, 254, P_BN254)
    assert len({*xs, *ys}) == 2 * T
    mds = [[pow((xs[i] + ys[j]) % P_BN254, P_BN254 - 2, P_BN254)
            for j in range(T)] for i in range(T)]
    return rc, mds


def _permute_bn254(state: list[int]) -> list[int]:
    """Poseidon permutation over BN254, t=5, x^5 S-box, 8 full + 60 partial
    rounds (circomlib parameterization: ark -> sbox -> MDS mix every round,
    partial-round S-box on element 0)."""
    rc, mds = _constants()
    p = P_BN254
    half = R_F // 2
    s = [x % p for x in state]
    for r in range(R_F + R_P):
        s = [(x + c) % p for x, c in zip(s, rc[r])]
        if r < half or r >= half + R_P:
            s = [pow(x, 5, p) for x in s]
        else:
            s[0] = pow(s[0], 5, p)
        s = [sum(mds[i][j] * s[j] for j in range(T)) % p for i in range(T)]
    return s


GOLDILOCKS = 0xFFFFFFFF00000001
_U64 = 0xFFFFFFFFFFFFFFFF


def permute_bn128(inputs: list[int]) -> list[int]:
    """12 Goldilocks u64 -> 12 Goldilocks u64 via the packed BN254
    permutation (reference: poseidon_bn128.rs permute FFI + the conditional
    ORDER subtraction :80-140). Bit-exact to the reference KATs."""
    assert len(inputs) == 12
    state = [0]
    for i in range(4):
        state.append((inputs[3 * i] << 128) | (inputs[3 * i + 1] << 64)
                     | inputs[3 * i + 2])
    out = _permute_bn254(state)
    result = []
    for v in out[:4]:
        for limb in ((v >> 128) & _U64, (v >> 64) & _U64, v & _U64):
            if limb >= GOLDILOCKS:
                limb -= GOLDILOCKS
            result.append(limb)
    return result


SPONGE_RATE = 8
NUM_HASH_OUT_ELTS = 4


def hash_n_to_m_no_pad_bn128(inputs: list[int], num_outputs: int) -> list[int]:
    state = [0] * 12
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start:start + SPONGE_RATE]
        state[:len(chunk)] = [x % GOLDILOCKS for x in chunk]
        state = permute_bn128(state)
    outputs = []
    while True:
        for s in state[:SPONGE_RATE]:
            outputs.append(s)
            if len(outputs) == num_outputs:
                return outputs
        state = permute_bn128(state)


def hash_no_pad_bn128(inputs: list[int]) -> list[int]:
    return hash_n_to_m_no_pad_bn128(inputs, NUM_HASH_OUT_ELTS)


def two_to_one_bn128(left: list[int], right: list[int]) -> list[int]:
    return hash_no_pad_bn128(list(left) + list(right))
