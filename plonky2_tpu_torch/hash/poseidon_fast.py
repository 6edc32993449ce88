"""Fast-partial-rounds Poseidon formulation — constants DERIVED, not copied.

The reference bakes precomputed tables (FAST_PARTIAL_FIRST_ROUND_CONSTANT,
FAST_PARTIAL_ROUND_CONSTANTS, FAST_PARTIAL_ROUND_VS / _W_HATS,
FAST_PARTIAL_ROUND_INITIAL_MATRIX) into the binary
(reference: plonky2/src/hash/poseidon_goldilocks.rs:27-181; the computation
that consumes them: plonky2/src/hash/poseidon.rs — partial_first_constant_layer
:368, mds_partial_layer_init :414, mds_partial_layer_fast_field :489).

Here the tables are derived at import time from the MDS matrix and round
constants via the sparse-factorization algorithm of the Poseidon paper
(Appendix B): every consecutive pair of partial rounds factors the MDS matrix
M^T = M' · M'' with M'' sparse (row 0 = (M00, w_hat), col 0 = v, identity
elsewhere), and round constants are commuted backwards through the linear
layers. The fast path is bit-identical to the naive permutation; the tests
hold it against the reference's known-answer vectors.

All math is python ints mod p (host-side, one-time).
"""

from __future__ import annotations

from functools import lru_cache

from ..field import reference as ref
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS, HALF_N_FULL_ROUNDS, MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG, N_PARTIAL_ROUNDS, N_ROUNDS, SPONGE_WIDTH,
)

T = SPONGE_WIDTH
P = ref.ORDER


def _mds_matrix() -> list[list[int]]:
    """M with (M @ state)[r] = sum_c M[r][c]*state[c], matching mds_row_shf:
    row r coefficient of state[c] is CIRC[(c - r) % 12], plus DIAG on the
    diagonal."""
    m = [[MDS_MATRIX_CIRC[(c - r) % T] for c in range(T)] for r in range(T)]
    for r in range(T):
        m[r][r] = (m[r][r] + MDS_MATRIX_DIAG[r]) % P
    return m


def _mat_transpose(m):
    return [list(row) for row in zip(*m)]


def _mat_mul(a, b):
    n, k, mcols = len(a), len(b), len(b[0])
    out = [[0] * mcols for _ in range(n)]
    for i in range(n):
        ai = a[i]
        for j in range(mcols):
            out[i][j] = sum(ai[l] * b[l][j] for l in range(k)) % P
    return out


def _mat_vec(m, v):
    return [sum(mi[j] * v[j] for j in range(len(v))) % P for mi in m]


def _vec_mat(v, m):
    return [sum(v[i] * m[i][j] for i in range(len(v))) % P
            for j in range(len(m[0]))]


def _mat_inverse(m):
    """Gauss-Jordan inverse mod p."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = ref.inverse(a[col][col])
        a[col] = [(x * inv) % P for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] % P != 0:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


@lru_cache(maxsize=None)
def fast_partial_tables():
    """Returns (first_rc[12], partial_rc[22], vs[22][11], w_hats[22][11],
    init_mat[11][11]) as python ints, bit-identical to the reference tables."""
    M = _mds_matrix()
    MT = _mat_transpose(M)
    inv_MT = _mat_inverse(MT)

    # --- equivalent round constants: move each partial round's constants
    # backwards through the preceding linear layer. Walking rounds from the
    # last partial round down to the first full-round boundary, each constant
    # vector c splits into its lane-0 part (stays, applied after that round's
    # S-box) and the rest (commuted into the previous round: M@x + c =
    # M@(x + M^{-1}c)).
    rc_rows = [list(ALL_ROUND_CONSTANTS[r * T:(r + 1) * T])
               for r in range(N_ROUNDS)]
    last_partial = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS - 1
    for i in range(last_partial - 1, HALF_N_FULL_ROUNDS - 1, -1):
        inv_cip1 = _vec_mat(rc_rows[i + 1], inv_MT)
        rc_rows[i] = [(x + (y if j else 0)) % P
                      for j, (x, y) in enumerate(zip(rc_rows[i], inv_cip1))]
        rc_rows[i + 1] = [inv_cip1[0]] + [0] * (T - 1)

    first_rc = rc_rows[HALF_N_FULL_ROUNDS]
    partial_rc = [rc_rows[HALF_N_FULL_ROUNDS + 1 + r][0]
                  for r in range(N_PARTIAL_ROUNDS - 1)] + [0]

    # --- sparse factorization of M^T, iterated over the partial rounds.
    # Each step: M_mul = [[m00, v],[w, M_hat]];  w_hat = M_hat^{-1} w.
    # The sparse layer for that step is [[m00, w_hat^T],[v^T?, ...]] — in the
    # plonky2 convention the stored vs/w_hats apply as
    #   out[0] = M00*s0 + sum w_hat[i-1]*s[i];  out[i] = s[i] + vs[i-1]*s0,
    # and collections are consumed in REVERSE derivation order.
    vs_rev, w_hats_rev = [], []
    M_mul = MT
    M_i = None
    for _ in range(N_PARTIAL_ROUNDS):
        M_hat = [row[1:] for row in M_mul[1:]]
        w = [row[0] for row in M_mul[1:]]
        v = M_mul[0][1:]
        vs_rev.append(v)
        w_hats_rev.append(_mat_vec(_mat_inverse(M_hat), w))
        M_i = [[int(i == j) for j in range(T)] for i in range(T)]
        for i in range(1, T):
            for j in range(1, T):
                M_i[i][j] = M_hat[i - 1][j - 1]
        M_mul = _mat_mul(MT, M_i)

    vs = list(reversed(vs_rev))
    w_hats = list(reversed(w_hats_rev))
    init_mat = [row[1:] for row in M_i[1:]]
    return (first_rc, partial_rc, vs, w_hats, init_mat)


# ---------------------------------------------------------------------------
# Generic evaluation of the fast-path permutation over any algebra.
#
# `alg` provides: add(a,b), mul(a,b), mul_const(a, int), add_const(a, int),
# sbox via mul; `state` is a 12-list of algebra elements. This single
# implementation serves the host permutation and witness trace (int algebra)
# and the PoseidonGate's constraints at zeta (ext2 algebra).
# ---------------------------------------------------------------------------

def constant_layer(alg, state, round_ctr):
    return [alg.add_const(x, ALL_ROUND_CONSTANTS[round_ctr * T + i])
            for i, x in enumerate(state)]


def sbox_monomial(alg, x):
    x2 = alg.mul(x, x)
    x3 = alg.mul(x2, x)
    x6 = alg.mul(x3, x3)
    return alg.mul(x6, x)


def sbox_layer(alg, state):
    return [sbox_monomial(alg, x) for x in state]


def mds_layer(alg, state):
    out = []
    for r in range(T):
        acc = alg.mul_const(state[r], MDS_MATRIX_DIAG[r]) if MDS_MATRIX_DIAG[r] \
            else None
        for i in range(T):
            term = alg.mul_const(state[(i + r) % T], MDS_MATRIX_CIRC[i])
            acc = term if acc is None else alg.add(acc, term)
        out.append(acc)
    return out


def partial_first_constant_layer(alg, state):
    first_rc = fast_partial_tables()[0]
    return [alg.add_const(x, first_rc[i]) for i, x in enumerate(state)]


def mds_partial_layer_init(alg, state):
    init_mat = fast_partial_tables()[4]
    out = [state[0]]
    for c in range(1, T):
        acc = None
        for r in range(1, T):
            term = alg.mul_const(state[r], init_mat[r - 1][c - 1])
            acc = term if acc is None else alg.add(acc, term)
        out.append(acc)
    return out


def mds_partial_layer_fast(alg, state, r):
    _, _, vs, w_hats, _ = fast_partial_tables()
    mds0to0 = MDS_MATRIX_CIRC[0] + MDS_MATRIX_DIAG[0]
    d = alg.mul_const(state[0], mds0to0)
    for i in range(1, T):
        d = alg.add(d, alg.mul_const(state[i], w_hats[r][i - 1]))
    out = [d]
    for i in range(1, T):
        out.append(alg.add(state[i], alg.mul_const(state[0], vs[r][i - 1])))
    return out


def poseidon_fast(alg, state):
    """Full permutation via the fast-partial-rounds path (bit-identical to
    the naive schedule; reference poseidon.rs:745-765)."""
    partial_rc = fast_partial_tables()[1]
    round_ctr = 0
    for _ in range(HALF_N_FULL_ROUNDS):
        state = constant_layer(alg, state, round_ctr)
        state = sbox_layer(alg, state)
        state = mds_layer(alg, state)
        round_ctr += 1
    state = partial_first_constant_layer(alg, state)
    state = mds_partial_layer_init(alg, state)
    for r in range(N_PARTIAL_ROUNDS):
        s0 = sbox_monomial(alg, state[0])
        if r < N_PARTIAL_ROUNDS - 1:
            s0 = alg.add_const(s0, partial_rc[r])
        state = [s0] + state[1:]
        state = mds_partial_layer_fast(alg, state, r)
    round_ctr += N_PARTIAL_ROUNDS
    for _ in range(HALF_N_FULL_ROUNDS):
        state = constant_layer(alg, state, round_ctr)
        state = sbox_layer(alg, state)
        state = mds_layer(alg, state)
        round_ctr += 1
    return state


class IntAlgebra:
    """Base-field python ints."""

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def mul_const(a, c):
        return (a * c) % P

    @staticmethod
    def add_const(a, c):
        return (a + c) % P

    @staticmethod
    def const(c):
        return c % P

    @staticmethod
    def zero():
        return 0


INT = IntAlgebra()
