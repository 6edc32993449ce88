"""Curve gadgets: secp256k1 point arithmetic inside a circuit.

Reference: ecdsa/src/gadgets/curve.rs — AffinePointTarget (:18-27),
curve_assert_valid (:107-122), curve_double (:135-160), curve_add
(:173-194: incomplete addition, points assumed distinct and nonzero),
curve_conditional_add (:196-210), curve_scalar_mul (:212-252: double-and-add
started at a random point to dodge the zero point); gadgets/glv.rs glv_mul
(:21-80); gadgets/ecdsa.rs verify_message_circuit (:31-52).
"""

from __future__ import annotations

import dataclasses
import secrets

from . import curve as native
from .nonnative import NonNativeTarget, set_nonnative_target


@dataclasses.dataclass(frozen=True)
class AffinePointTarget:
    """Nonzero affine point; incomplete arithmetic for efficiency."""
    x: NonNativeTarget
    y: NonNativeTarget


@dataclasses.dataclass(frozen=True)
class ECDSAPublicKeyTarget:
    point: AffinePointTarget


@dataclasses.dataclass(frozen=True)
class ECDSASignatureTarget:
    r: NonNativeTarget
    s: NonNativeTarget


def set_affine_point_target(pw, t: AffinePointTarget,
                            p: native.AffinePoint) -> None:
    assert not p.zero
    set_nonnative_target(pw, t.x, p.x)
    set_nonnative_target(pw, t.y, p.y)


class CurveGadgets:
    """Mixin for CircuitBuilder. All points are secp256k1 (base field P)."""

    def constant_affine_point(self, p: native.AffinePoint
                              ) -> AffinePointTarget:
        assert not p.zero
        return AffinePointTarget(
            x=self.constant_nonnative(p.x, native.P),
            y=self.constant_nonnative(p.y, native.P))

    def add_virtual_affine_point_target(self) -> AffinePointTarget:
        return AffinePointTarget(
            x=self.add_virtual_nonnative_target(native.P),
            y=self.add_virtual_nonnative_target(native.P))

    def connect_affine_point(self, a: AffinePointTarget,
                             b: AffinePointTarget) -> None:
        self.connect_nonnative(a.x, b.x)
        self.connect_nonnative(a.y, b.y)

    def curve_assert_valid(self, p: AffinePointTarget) -> None:
        a = self.constant_nonnative(native.A, native.P)
        b = self.constant_nonnative(native.B, native.P)
        y2 = self.mul_nonnative(p.y, p.y)
        x2 = self.mul_nonnative(p.x, p.x)
        x3 = self.mul_nonnative(x2, p.x)
        ax = self.mul_nonnative(a, p.x)
        ax_b = self.add_nonnative(ax, b)
        rhs = self.add_nonnative(x3, ax_b)
        self.connect_nonnative(y2, rhs)

    def curve_neg(self, p: AffinePointTarget) -> AffinePointTarget:
        return AffinePointTarget(p.x, self.neg_nonnative(p.y))

    def curve_conditional_neg(self, p: AffinePointTarget,
                              b) -> AffinePointTarget:
        return AffinePointTarget(p.x, self.nonnative_conditional_neg(p.y, b))

    def curve_double(self, p: AffinePointTarget) -> AffinePointTarget:
        double_y = self.add_nonnative(p.y, p.y)
        inv_double_y = self.inv_nonnative(double_y)
        x2 = self.mul_nonnative(p.x, p.x)
        x2_2 = self.add_nonnative(x2, x2)
        x2_3 = self.add_nonnative(x2_2, x2)
        a = self.constant_nonnative(native.A, native.P)
        num = self.add_nonnative(x2_3, a)
        lam = self.mul_nonnative(num, inv_double_y)
        lam2 = self.mul_nonnative(lam, lam)
        two_x = self.add_nonnative(p.x, p.x)
        x3 = self.sub_nonnative(lam2, two_x)
        x_diff = self.sub_nonnative(p.x, x3)
        y3 = self.sub_nonnative(self.mul_nonnative(lam, x_diff), p.y)
        return AffinePointTarget(x3, y3)

    def curve_repeated_double(self, p: AffinePointTarget,
                              n: int) -> AffinePointTarget:
        for _ in range(n):
            p = self.curve_double(p)
        return p

    def curve_add(self, p1: AffinePointTarget,
                  p2: AffinePointTarget) -> AffinePointTarget:
        """Incomplete addition: p1 != +-p2, both nonzero."""
        u = self.sub_nonnative(p2.y, p1.y)
        v = self.sub_nonnative(p2.x, p1.x)
        s = self.mul_nonnative(u, self.inv_nonnative(v))
        s2 = self.mul_nonnative(s, s)
        x_sum = self.add_nonnative(p2.x, p1.x)
        x3 = self.sub_nonnative(s2, x_sum)
        x_diff = self.sub_nonnative(p1.x, x3)
        y3 = self.sub_nonnative(self.mul_nonnative(s, x_diff), p1.y)
        return AffinePointTarget(x3, y3)

    def curve_conditional_add(self, p1: AffinePointTarget,
                              p2: AffinePointTarget, b) -> AffinePointTarget:
        not_b = self.not_(b)
        total = self.curve_add(p1, p2)
        x = self.add_nonnative(self.mul_nonnative_by_bool(total.x, b),
                               self.mul_nonnative_by_bool(p1.x, not_b))
        y = self.add_nonnative(self.mul_nonnative_by_bool(total.y, b),
                               self.mul_nonnative_by_bool(p1.y, not_b))
        return AffinePointTarget(x, y)

    def _curve_select(self, b, p_true: AffinePointTarget,
                      p_false: AffinePointTarget) -> AffinePointTarget:
        not_b = self.not_(b)
        x = self.add_nonnative(self.mul_nonnative_by_bool(p_true.x, b),
                               self.mul_nonnative_by_bool(p_false.x, not_b))
        y = self.add_nonnative(self.mul_nonnative_by_bool(p_true.y, b),
                               self.mul_nonnative_by_bool(p_false.y, not_b))
        return AffinePointTarget(x, y)

    def curve_scalar_mul(self, p: AffinePointTarget,
                         n: NonNativeTarget) -> AffinePointTarget:
        """Double-and-add over the scalar's bits; the accumulator starts at a
        random public point (subtracted at the end) so the zero point never
        appears (reference: curve.rs:212-252)."""
        bits = self.split_nonnative_to_bits(n)
        rando = native.GENERATOR.mul(secrets.randbelow(native.N - 2) + 1)
        randot = self.constant_affine_point(rando)
        result = randot
        two_i_p = p
        for i, bit in enumerate(bits):
            result = self.curve_conditional_add(result, two_i_p, bit)
            if i + 1 < len(bits):
                two_i_p = self.curve_double(two_i_p)
        return self.curve_add(result, self.curve_neg(randot))

    def glv_mul(self, p: AffinePointTarget,
                k: NonNativeTarget) -> AffinePointTarget:
        """GLV scalar mul: witness the decomposition k = k1 + s*k2, constrain
        it in-circuit, then two half-width muls
        (reference: gadgets/glv.rs:21-80)."""
        k1 = self.add_virtual_nonnative_target(native.N)
        k2 = self.add_virtual_nonnative_target(native.N)
        k1_neg = self.add_virtual_target()
        k2_neg = self.add_virtual_target()
        self.add_simple_generator(_GlvDecompositionGenerator(
            k, k1, k2, k1_neg, k2_neg))
        self.assert_bool(k1_neg)
        self.assert_bool(k2_neg)
        # constrain k1_signed + s * k2_signed = k (mod n)
        s_const = self.constant_nonnative(native.GLV_S, native.N)
        k1_signed = self.nonnative_conditional_neg(k1, k1_neg)
        k2_signed = self.nonnative_conditional_neg(k2, k2_neg)
        s_k2 = self.mul_nonnative(s_const, k2_signed)
        recombined = self.add_nonnative(k1_signed, s_k2)
        self.connect_nonnative(recombined, k)

        beta = self.constant_nonnative(native.GLV_BETA, native.P)
        sp = AffinePointTarget(self.mul_nonnative(beta, p.x), p.y)
        first = self.curve_conditional_neg(p, k1_neg)
        second = self.curve_conditional_neg(sp, k2_neg)
        part1 = self.curve_scalar_mul(first, k1)
        part2 = self.curve_scalar_mul(second, k2)
        return self.curve_add(part1, part2)


class _GlvDecompositionGenerator:
    def __init__(self, k, k1, k2, k1_neg, k2_neg):
        self.k, self.k1, self.k2 = k, k1, k2
        self.k1_neg, self.k2_neg = k1_neg, k2_neg

    def watch_list(self):
        return list(self.k.value.limbs)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        from .nonnative import get_nonnative_target
        k = get_nonnative_target(witness, self.k)
        k1, k2, k1_neg, k2_neg = native.decompose_secp256k1_scalar(k)
        for i, t in enumerate(self.k1.value.limbs):
            out.append((t, (k1 >> (32 * i)) & 0xFFFFFFFF))
        for i, t in enumerate(self.k2.value.limbs):
            out.append((t, (k2 >> (32 * i)) & 0xFFFFFFFF))
        out.append((self.k1_neg, 1 if k1_neg else 0))
        out.append((self.k2_neg, 1 if k2_neg else 0))
        return True


def verify_message_circuit(builder, msg: NonNativeTarget,
                           sig: ECDSASignatureTarget,
                           pk: ECDSAPublicKeyTarget) -> None:
    """In-circuit ECDSA verification
    (reference: gadgets/ecdsa.rs:31-52)."""
    builder.curve_assert_valid(pk.point)
    c = builder.inv_nonnative(sig.s)
    u1 = builder.mul_nonnative(msg, c)
    u2 = builder.mul_nonnative(sig.r, c)
    point1 = builder.curve_scalar_mul(
        builder.constant_affine_point(native.GENERATOR), u1)
    point2 = builder.glv_mul(pk.point, u2)
    point = builder.curve_add(point1, point2)
    # the reference reinterprets x's limbs as a scalar and requires limb
    # equality with r (ecdsa.rs:50-51) — no mod-n reduction
    x_as_scalar = NonNativeTarget(point.x.value, native.N)
    builder.connect_nonnative(sig.r, x_as_scalar)
