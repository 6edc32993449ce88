"""Pure-Python (arbitrary-precision int) Goldilocks arithmetic: the host
oracle and the host-side precomputation (twiddles, circuit constants) of
the port. Copy of the reference's field/reference.py trimmed to what the
port calls.

Semantics match the reference field (reference: field/src/goldilocks_field.rs:
ORDER, EPSILON, TWO_ADICITY=32, MULTIPLICATIVE_GROUP_GENERATOR=7,
POWER_OF_TWO_GENERATOR=1753635133440165772).
"""

from __future__ import annotations

ORDER = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
TWO_ADICITY = 32
MULTIPLICATIVE_GROUP_GENERATOR = 7
POWER_OF_TWO_GENERATOR = 1753635133440165772
# Quadratic extension F[X]/(X^2 - 7)
# (reference: field/src/extension/quadratic.rs)
EXT2_W = 7


def add(a: int, b: int) -> int:
    return (a + b) % ORDER


def sub(a: int, b: int) -> int:
    return (a - b) % ORDER


def neg(a: int) -> int:
    return (-a) % ORDER


def mul(a: int, b: int) -> int:
    return (a * b) % ORDER


def exp(a: int, e: int) -> int:
    return pow(a, e, ORDER)


def inverse(a: int) -> int:
    assert a % ORDER != 0, "0 has no inverse"
    return pow(a, ORDER - 2, ORDER)


def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity."""
    assert 0 <= n_log <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), ORDER)


def two_adic_subgroup(n_log: int) -> list[int]:
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(mul(out[-1], g))
    return out


def inverse_2exp(exp_: int) -> int:
    """1 / 2^exp_ mod p."""
    return inverse(pow(2, exp_, ORDER))


# ---------------------------------------------------------------------------
# Quadratic extension ops: element = (a0, a1) meaning a0 + a1*X, X^2 = 7.
# ---------------------------------------------------------------------------

def ext2_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def ext2_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def ext2_mul(a, b):
    # (a0 + a1 X)(b0 + b1 X) = a0b0 + 7 a1b1 + (a0b1 + a1b0) X
    c0 = add(mul(a[0], b[0]), mul(EXT2_W, mul(a[1], b[1])))
    c1 = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return (c0, c1)


def ext2_scalar_mul(a, s: int):
    return (mul(a[0], s), mul(a[1], s))


def ext2_inverse(a):
    # Norm = a0^2 - 7 a1^2; inverse = conj(a) / Norm.
    norm = sub(mul(a[0], a[0]), mul(EXT2_W, mul(a[1], a[1])))
    ninv = inverse(norm)
    return (mul(a[0], ninv), mul(neg(a[1]), ninv))


def ext2_exp(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = ext2_mul(result, base)
        base = ext2_mul(base, base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Quintic extension F[X]/(X^5 - 3), the base field of EcGFp5 (reference:
# field/src/extension/quintic.rs, goldilocks_extensions.rs:40-93): elements
# are 5-tuples of python ints, written generically over D = len(a).
# ---------------------------------------------------------------------------

EXT5_W = 3
EXT5_DTH_ROOT = 1041288259238279555


def extn_add(a, b):
    return tuple(add(x, y) for x, y in zip(a, b))


def extn_sub(a, b):
    return tuple(sub(x, y) for x, y in zip(a, b))


def extn_neg(a):
    return tuple(neg(x) for x in a)


def extn_scalar_mul(a, s: int):
    return tuple(mul(x, s) for x in a)


def extn_mul(a, b, w: int):
    """c_k = sum_{i+j=k} a_i b_j + W sum_{i+j=k+D} a_i b_j."""
    d = len(a)
    c = [0] * d
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = mul(ai, bj)
            if i + j < d:
                c[i + j] = add(c[i + j], t)
            else:
                c[i + j - d] = add(c[i + j - d], mul(w, t))
    return tuple(c)


def extn_frobenius(a, dth_root: int, count: int = 1):
    """a -> a^(p^count): coefficient i times DTH_ROOT^(i*count)
    (reference: extension/mod.rs:29-60 repeated_frobenius)."""
    z0 = exp(dth_root, count % len(a))
    z = 1
    out = []
    for x in a:
        out.append(mul(x, z))
        z = mul(z, z0)
    return tuple(out)


def extn_inverse(a, w: int, dth_root: int):
    """a^-1 = (prod_{k=1..D-1} a^(p^k)) / N(a), N(a) the product of all
    conjugates, which lies in the base field."""
    acc = extn_frobenius(a, dth_root, 1)
    for k in range(2, len(a)):
        acc = extn_mul(acc, extn_frobenius(a, dth_root, k), w)
    norm = extn_mul(a, acc, w)
    assert all(x == 0 for x in norm[1:]), "norm not in base field"
    return extn_scalar_mul(acc, inverse(norm[0]))
