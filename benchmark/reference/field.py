"""Goldilocks arithmetic on python ints, for the reference checks.

p = 2^64 - 2^32 + 1; its multiplicative group is generated by 7, and its
2^32-th roots of unity by 1753635133440165772 (plonky2's
field/src/goldilocks_field.rs). The quadratic extension is F[X]/(X^2 - 7);
an element is a pair (c0, c1) meaning c0 + c1 X.
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1
GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772
W = 7  # X^2 = W in the extension

ZERO = (0, 0)
ONE = (1, 0)


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("0 has no inverse")
    return pow(a, P - 2, P)


def root_of_unity(log_n: int) -> int:
    """A primitive 2^log_n-th root of unity."""
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - log_n), P)


def reverse_bits(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def e_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def e_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def e_mul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def e_scale(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def e_pow(a, e: int):
    out = ONE
    while e:
        if e & 1:
            out = e_mul(out, a)
        a = e_mul(a, a)
        e >>= 1
    return out


def e_inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    n_inv = inv(norm)
    return (a[0] * n_inv % P, -a[1] * n_inv % P)


def e_horner(coeffs, x):
    """sum_i coeffs[i] x^i."""
    acc = ZERO
    for c in reversed(list(coeffs)):
        acc = e_add(e_mul(acc, x), c)
    return acc


def as_ext(v):
    """An opened value as an extension pair of canonical ints; refuses
    anything else."""
    c0, c1 = (int(x) for x in v)
    if not (0 <= c0 < P and 0 <= c1 < P):
        raise ValueError("opening outside the field")
    return (c0, c1)
