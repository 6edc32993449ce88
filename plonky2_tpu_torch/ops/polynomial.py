"""Polynomial routines of the FRI opening path (plonky2_tpu/ops/polynomial.py):
alpha-reduction of base-field polynomials, division by (X - z) as a suffix
sum, the FRI Horner fold and evaluation at an extension point."""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..field.extension import GF2, gf2_powers


def reduce_polys_base(polys: torch.Tensor, alpha) -> GF2:
    """sum_j alpha^j * polys[j] for base-field polys [num, N] -> GF2 [N]."""
    apow = gf2_powers(alpha, polys.shape[0], polys.device)
    return GF2(gl.reduce_sum(gl.mul(polys, apow.c0.unsqueeze(1)), 0),
               gl.reduce_sum(gl.mul(polys, apow.c1.unsqueeze(1)), 0))


def divide_by_linear(p: GF2, z) -> GF2:
    """Quotient of p(X) by (X - z) for a host extension point z, dropping the
    remainder: q_i = z^{-(i+1)} sum_{j>i} p_j z^j. Returns [N] with the last
    coefficient zero."""
    n = p.shape[-1]
    device = p.c0.device
    w = p * gf2_powers(z, n, device)
    s = GF2(gl.suffix_sum(w.c0), gl.suffix_sum(w.c1))
    zinv = ref.ext2_inverse(tuple(z))
    zinv_pow = gf2_powers(zinv, n, device) * GF2.const(zinv, device)
    s_shift = GF2.cat([s[1:], GF2.zeros((1,), device)])
    return s_shift * zinv_pow


def mul_poly_by_x(p: GF2) -> GF2:
    """Coefficients shifted up by one (times X), one longer: the okx
    circom-compatible final polynomial (reference: fri/oracle.rs:547)."""
    return GF2.cat([GF2.zeros((1,), p.c0.device), p])


def horner_fold(coeffs: GF2, beta, arity_bits: int) -> GF2:
    """out[j] = sum_i coeffs[j * arity + i] * beta^i."""
    arity = 1 << arity_bits
    ch = coeffs.reshape(-1, arity)
    b = GF2.const(beta, coeffs.c0.device)
    acc = ch[:, arity - 1]
    for i in range(arity - 2, -1, -1):
        acc = acc * b + ch[:, i]
    return acc


def eval_poly_ext(coeffs: GF2, x) -> GF2:
    """p(x) for a host extension point x."""
    xp = gf2_powers(x, coeffs.shape[-1], coeffs.c0.device)
    return (coeffs * xp).reduce_sum(-1)
