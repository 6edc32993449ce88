"""Extension-algebra ops over an abstract evaluation algebra.

Gates that operate on quadratic-extension *wire pairs* (ArithmeticExtension,
MulExtension, Reducing*, CosetInterpolation) compute in the formal algebra
F_eval[X]/(X^2 - W): elements are pairs (a0, a1) of evaluation-algebra
elements (reference: field/src/extension/algebra.rs ExtensionAlgebra).
One implementation serves the prover (int64 field tensors), the verifier (python-int
ext2 scalars) and later the recursive verifier (extension targets).
"""

from __future__ import annotations

W = 7  # X^2 - 7, same irreducible as the proving extension


def ext_add(alg, a, b):
    return (alg.add(a[0], b[0]), alg.add(a[1], b[1]))


def ext_sub(alg, a, b):
    return (alg.sub(a[0], b[0]), alg.sub(a[1], b[1]))


def ext_mul(alg, a, b):
    c0 = alg.add(alg.mul(a[0], b[0]), alg.mul_const(alg.mul(a[1], b[1]), W))
    c1 = alg.add(alg.mul(a[0], b[1]), alg.mul(a[1], b[0]))
    return (c0, c1)


def ext_scalar_mul(alg, a, s):
    """Multiply by an evaluation-algebra scalar s."""
    return (alg.mul(a[0], s), alg.mul(a[1], s))


def ext_scalar_mul_const(alg, a, c: int):
    return (alg.mul_const(a[0], c), alg.mul_const(a[1], c))


def ext_from_base(alg, x):
    return (x, alg.zero())


def ext_zero(alg):
    return (alg.zero(), alg.zero())


def ext_one(alg):
    return (alg.const(1), alg.zero())


def ext_sub_base(alg, a, c: int):
    """a - c for base constant c."""
    return (alg.add_const(a[0], (-c) % 0xFFFFFFFF00000001), a[1])
