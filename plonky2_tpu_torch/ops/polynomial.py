"""Polynomial routines of the FRI opening path (plonky2_tpu/ops/polynomial.py):
alpha-reduction of base-field polynomials, division by (X - z) as a suffix
sum, the FRI Horner fold and evaluation at an extension point; and the
PLONK and STARK provers' quotient coset, quotient chunks and openings."""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..field.extension import GF2, gf2_powers
from ..utils import timing as tracing
from . import ntt

# elements of the coefficient block `eval_at_points` multiplies at once:
# wider blocks (a STARK trace of 128 columns over 2^20 rows) go in runs of
# rows
EVAL_CHUNK = 1 << 24


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


def eval_at_points(coeffs: torch.Tensor, zs: list) -> list:
    """Rows of coeffs [num, n] (shared by the proofs) or [num, B, n] (a
    row a proof) evaluated at zs, an extension point a proof: B lists of
    num (c0, c1) pairs."""
    n = coeffs.shape[-1]
    B = len(zs)
    powers = [gf2_powers(z, n, coeffs.device) for z in zs]
    zp0 = torch.stack([p.c0 for p in powers])             # [B, n]
    zp1 = torch.stack([p.c1 for p in powers])
    if coeffs.dim() == 2:
        coeffs = coeffs.unsqueeze(1)
    rows = max(1, EVAL_CHUNK // (n * B))
    c0, c1 = [], []
    for lo in range(0, coeffs.shape[0], rows):
        c = coeffs[lo:lo + rows]
        c0.append(gl.reduce_sum(gl.mul(c, zp0), -1))      # [rows, B]
        c1.append(gl.reduce_sum(gl.mul(c, zp1), -1))
    c0 = gl.to_u64(torch.cat(c0))
    c1 = gl.to_u64(torch.cat(c1))
    return [[(int(a), int(b)) for a, b in zip(c0[:, j], c1[:, j])]
            for j in range(B)]


def quotient_coset(degree_bits: int, qdb: int, points: tuple, device):
    """The quotient's coset x_i = g w^i, i < N = 2^(degree_bits + qdb), and
    (x, Z_H(x)^-1, L [len(points), N]): Z_H(x) = x^n - 1 (period 2^qdb in
    i) and L_a(x) = Z_H(x) / (n (x / a - 1)), the Lagrange selector of each
    subgroup point a of `points` (1 for L_0), n = 2^degree_bits."""
    degree = 1 << degree_bits
    N = degree << qdb
    shift = ref.MULTIPLICATIVE_GROUP_GENERATOR
    w = ref.primitive_root_of_unity(degree_bits + qdb)
    x = gl.mul_const(gl.powers(w, N, device), shift)
    zh = [ref.sub(ref.exp(ref.mul(shift, ref.exp(w, i)), degree), 1)
          for i in range(1 << qdb)]
    zh_t, zh_inv = (gl.from_u64(np.asarray(v, dtype=np.uint64),
                                device).repeat(N >> qdb)
                    for v in (zh, [ref.inverse(t) for t in zh]))
    one = gl.const(1, device)
    inv = gl.inverse(gl.mul_const(torch.stack([
        gl.sub(x if a == 1 else gl.mul_const(x, ref.inverse(a)), one)
        for a in points]), degree))
    return x, zh_inv, gl.mul(zh_t, inv)


def quotient_chunks(values: torch.Tensor, qdf: int,
                    degree: int) -> torch.Tensor:
    """The quotient's coefficient chunks [nc qdf, (B,) degree] from its
    values [nc, (B,) N] over the coset, already divided by Z_H: the coset
    iNTT cut to qdf degree coefficients, in qdf chunks a challenge."""
    nc, lead = values.shape[0], tuple(values.shape[1:-1])
    with tracing.scope("quotient iNTT", values.device):
        coeffs = ntt.coset_ifft(values)[..., :qdf * degree]
        return coeffs.reshape((nc,) + lead + (qdf, degree)).movedim(
            -2, 1).reshape((nc * qdf,) + lead + (degree,)).contiguous()
