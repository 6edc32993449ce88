"""EcGFp5 circuit gadgets: GF(p^5) arithmetic, curve targets, Schnorr
verification.

Reference: ecgfp5/src/gadgets/base_field.rs (QuinticExtensionTarget :30-40,
mul/div_or_zero :403-490, encode_quintic_ext_as_scalar :676-710),
gates/gfp5_mul.rs (MulGFp5Gate: out = c * (a *_{GF(p^5)} b), 15 wires/op,
degree 3, :30-230), gadgets/curve.rs (CurveTarget :25, complete add with
is_inf flags :158-235, windowed scalar mul :253-410, muladd_2 :366-420),
gadgets/schnorr.rs (schnorr_verify_circuit :82-105).
"""

from __future__ import annotations

import dataclasses

from ..field import reference as ref
from ..gates.gate import Gate
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from . import curve as ec

W5 = ref.EXT5_W


def _gfp5_mul_formula(alg, a, b, c_scalar):
    """c * (a * b) over GF(p^5), algebra-generic (reference:
    gfp5_mul.rs gfp5_mul_limbwise + gfp5_scalar_mul_limbwise)."""
    out = [alg.zero() for _ in range(5)]
    for i in range(5):
        for j in range(5):
            t = alg.mul(a[i], b[j])
            if i + j < 5:
                out[i + j] = alg.add(out[i + j], t)
            else:
                out[i + j - 5] = alg.add(out[i + j - 5],
                                         alg.mul_const(t, W5))
    return [alg.mul(c_scalar, x) for x in out]


class MulGFp5Gate(Gate):
    """Batched GF(p^5) multiplication: out = const_0 * (a * b)
    (reference: ecgfp5/src/gates/gfp5_mul.rs)."""

    WIRES_PER_OP = 15

    def __init__(self, num_ops: int):
        self._num_ops = num_ops

    @staticmethod
    def from_config(config):
        return MulGFp5Gate(config.num_routed_wires
                           // MulGFp5Gate.WIRES_PER_OP)

    def id(self):
        return f"MulGFp5Gate {{ num_ops: {self._num_ops} }}"

    def wires_multiplicand_0(self, i):
        return range(self.WIRES_PER_OP * i, self.WIRES_PER_OP * i + 5)

    def wires_multiplicand_1(self, i):
        return range(self.WIRES_PER_OP * i + 5, self.WIRES_PER_OP * i + 10)

    def wires_output(self, i):
        return range(self.WIRES_PER_OP * i + 10, self.WIRES_PER_OP * i + 15)

    def num_wires(self):
        return self._num_ops * self.WIRES_PER_OP

    def num_constants(self):
        return 1

    def degree(self):
        return 3

    def num_constraints(self):
        return self._num_ops * 5

    def num_ops(self):
        return self._num_ops

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        c = consts[0]
        out = []
        for i in range(self._num_ops):
            a = [wires[w] for w in self.wires_multiplicand_0(i)]
            b = [wires[w] for w in self.wires_multiplicand_1(i)]
            z = [wires[w] for w in self.wires_output(i)]
            computed = _gfp5_mul_formula(alg, a, b, c)
            for zi, ci in zip(z, computed):
                out.append(alg.sub(zi, ci))
        return out

    def generators(self, row, local_constants):
        return [_MulGFp5Generator(row, self, i, local_constants[0])
                for i in range(self._num_ops)]


class _MulGFp5Generator(SimpleGenerator):
    def __init__(self, row, gate, i, c):
        self.row, self.gate, self.i, self.c = row, gate, i, c

    def dependencies(self):
        g, i = self.gate, self.i
        return [wire(self.row, w) for w in g.wires_multiplicand_0(i)] + \
               [wire(self.row, w) for w in g.wires_multiplicand_1(i)]

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        a = tuple(witness.get(wire(self.row, w))
                  for w in g.wires_multiplicand_0(i))
        b = tuple(witness.get(wire(self.row, w))
                  for w in g.wires_multiplicand_1(i))
        prod = ref.extn_scalar_mul(ref.extn_mul(a, b, W5), self.c % ref.ORDER)
        for w, v in zip(g.wires_output(i), prod):
            out.append((wire(self.row, w), v))


@dataclasses.dataclass(frozen=True)
class CurveTarget:
    x: tuple       # 5 targets
    y: tuple       # 5 targets
    is_inf: object  # bool target


class Gfp5Gadgets:
    """Mixin for CircuitBuilder."""

    # -- quintic extension targets -------------------------------------------
    def add_virtual_quintic_ext_target(self):
        return tuple(self.add_virtual_targets(5))

    def constant_quintic_ext(self, c: tuple):
        return tuple(self.constant(int(x)) for x in c)

    def zero_quintic_ext(self):
        return self.constant_quintic_ext(ec.GFP5_ZERO)

    def one_quintic_ext(self):
        return self.constant_quintic_ext(ec.GFP5_ONE)

    def connect_quintic_ext(self, a, b) -> None:
        for x, y in zip(a, b):
            self.connect(x, y)

    def register_quintic_ext_public_input(self, a) -> None:
        self.register_public_inputs(list(a))

    def add_quintic_ext(self, a, b):
        return tuple(self.add(x, y) for x, y in zip(a, b))

    def add_const_quintic_ext(self, a, c: tuple):
        return tuple(self.add_const(x, int(v)) for x, v in zip(a, c))

    def sub_quintic_ext(self, a, b):
        return tuple(self.sub(x, y) for x, y in zip(a, b))

    def neg_quintic_ext(self, a):
        return tuple(self.mul_const(ref.ORDER - 1, x) for x in a)

    def double_quintic_ext(self, a):
        return tuple(self.add(x, x) for x in a)

    def triple_quintic_ext(self, a):
        return tuple(self.mul_const(3, x) for x in a)

    def select_quintic_ext(self, cond, a, b):
        return tuple(self.select(cond, x, y) for x, y in zip(a, b))

    def is_equal_quintic_ext(self, a, b):
        acc = self.one()
        for x, y in zip(a, b):
            acc = self.and_(acc, self.is_equal(x, y))
        return acc

    def weighted_mul_quintic_ext(self, c: int, a, b):
        """c * (a*b) via one MulGFp5Gate slot."""
        gate = MulGFp5Gate.from_config(self.config)
        row, i = self.find_slot(gate, ("gfp5mul", c % ref.ORDER),
                                [c % ref.ORDER])
        for t, w in zip(a, gate.wires_multiplicand_0(i)):
            self.connect(t, wire(row, w))
        for t, w in zip(b, gate.wires_multiplicand_1(i)):
            self.connect(t, wire(row, w))
        return tuple(wire(row, w) for w in gate.wires_output(i))

    def mul_quintic_ext(self, a, b):
        return self.weighted_mul_quintic_ext(1, a, b)

    def mul_const_quintic_ext(self, c: tuple, a):
        return self.mul_quintic_ext(self.constant_quintic_ext(c), a)

    def square_quintic_ext(self, a):
        return self.mul_quintic_ext(a, a)

    def add_many_quintic_ext(self, terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = self.add_quintic_ext(acc, t)
        return acc

    def div_or_zero_quintic_ext(self, a, b):
        """a/b, or 0 when b == 0 (reference: base_field.rs:462-490)."""
        quotient = self.add_virtual_quintic_ext_target()
        self.add_simple_generator(_QuinticQuotientGenerator(a, b, quotient))
        qb = self.mul_quintic_ext(quotient, b)
        diff = self.sub_quintic_ext(qb, a)
        for bi, pi in zip(b, diff):
            self.assert_zero(self.mul(bi, pi))
        return quotient

    def div_quintic_ext(self, a, b):
        return self.div_or_zero_quintic_ext(a, b)

    def inverse_quintic_ext(self, x):
        return self.div_or_zero_quintic_ext(self.one_quintic_ext(), x)

    def frob_quintic_ext(self, x, count: int = 1):
        z0 = ref.exp(ref.EXT5_DTH_ROOT, count % 5)
        z = 1
        out = []
        for c in x:
            out.append(self.mul_const(z, c))
            z = ref.mul(z, z0)
        return tuple(out)

    def encode_quintic_ext_as_scalar(self, x):
        """5x64 bits -> 10 u32 limbs -> scalar mod n
        (reference: base_field.rs:676-710)."""
        from ..ecdsa.biguint import BigUintTarget
        limbs = []
        for c in x:
            bits = self.split_le(c, 64)
            limbs.append(self.le_sum(bits[:32]))
            limbs.append(self.le_sum(bits[32:]))
        return self.reduce_biguint(BigUintTarget(tuple(limbs)), ec.N)

    # -- curve targets ---------------------------------------------------------
    def add_virtual_curve_target(self) -> CurveTarget:
        inf = self.add_virtual_target()
        self.assert_bool(inf)
        return CurveTarget(self.add_virtual_quintic_ext_target(),
                           self.add_virtual_quintic_ext_target(), inf)

    def curve_constant(self, p: ec.WeierstrassPoint) -> CurveTarget:
        return CurveTarget(self.constant_quintic_ext(p.x),
                           self.constant_quintic_ext(p.y),
                           self.constant(1 if p.is_inf else 0))

    def curve_zero(self) -> CurveTarget:
        return self.curve_constant(ec.NEUTRAL)

    def curve_generator_gfp5(self) -> CurveTarget:
        return self.curve_constant(ec.GENERATOR)

    def register_curve_public_input(self, p: CurveTarget) -> None:
        self.register_quintic_ext_public_input(p.x)
        self.register_quintic_ext_public_input(p.y)
        self.register_public_input(p.is_inf)

    def curve_eq(self, a: CurveTarget, b: CurveTarget):
        both_inf = self.and_(a.is_inf, b.is_inf)
        x_eq = self.is_equal_quintic_ext(a.x, b.x)
        y_eq = self.is_equal_quintic_ext(a.y, b.y)
        neither = self.and_(self.not_(a.is_inf), self.not_(b.is_inf))
        same = self.and_(neither, self.and_(x_eq, y_eq))
        return self.or_(both_inf, same)

    def curve_select(self, cond, a: CurveTarget,
                     b: CurveTarget) -> CurveTarget:
        return CurveTarget(self.select_quintic_ext(cond, a.x, b.x),
                           self.select_quintic_ext(cond, a.y, b.y),
                           self.select(cond, a.is_inf, b.is_inf))

    def curve_random_access(self, index, points) -> CurveTarget:
        xs = [self.random_access(index, [p.x[i] for p in points])
              for i in range(5)]
        ys = [self.random_access(index, [p.y[i] for p in points])
              for i in range(5)]
        inf = self.random_access(index, [p.is_inf for p in points])
        return CurveTarget(tuple(xs), tuple(ys), inf)

    def curve_add_gfp5(self, a: CurveTarget, b: CurveTarget) -> CurveTarget:
        """Complete addition (reference: curve.rs:158-196)."""
        x_same = self.is_equal_quintic_ext(a.x, b.x)
        y_diff = self.not_(self.is_equal_quintic_ext(a.y, b.y))
        lam0_notsame = self.sub_quintic_ext(b.y, a.y)
        lam0_same = self.add_const_quintic_ext(
            self.weighted_mul_quintic_ext(3, a.x, a.x), ec.A)
        lam1_notsame = self.sub_quintic_ext(b.x, a.x)
        lam1_same = self.double_quintic_ext(a.y)
        lam0 = self.select_quintic_ext(x_same, lam0_same, lam0_notsame)
        lam1 = self.select_quintic_ext(x_same, lam1_same, lam1_notsame)
        lam = self.div_or_zero_quintic_ext(lam0, lam1)
        x3 = self.sub_quintic_ext(
            self.sub_quintic_ext(self.square_quintic_ext(lam), a.x), b.x)
        y3 = self.sub_quintic_ext(
            self.mul_quintic_ext(lam, self.sub_quintic_ext(a.x, x3)), a.y)
        c_is_inf = self.and_(x_same, y_diff)
        c = CurveTarget(x3, y3, c_is_inf)
        sel = self.curve_select(a.is_inf, b, c)
        return self.curve_select(b.is_inf, a, sel)

    def curve_double_gfp5(self, a: CurveTarget) -> CurveTarget:
        lam0 = self.add_const_quintic_ext(
            self.weighted_mul_quintic_ext(3, a.x, a.x), ec.A)
        lam1 = self.double_quintic_ext(a.y)
        lam = self.div_or_zero_quintic_ext(lam0, lam1)
        x2 = self.sub_quintic_ext(self.square_quintic_ext(lam),
                                  self.double_quintic_ext(a.x))
        y2 = self.sub_quintic_ext(
            self.mul_quintic_ext(lam, self.sub_quintic_ext(a.x, x2)), a.y)
        return CurveTarget(x2, y2, a.is_inf)

    def curve_assert_not_zero(self, p: CurveTarget) -> None:
        eq = self.curve_eq(p, self.curve_zero())
        self.assert_zero(eq)

    def precompute_window_gfp5(self, a: CurveTarget,
                               window_bits: int) -> list:
        multiples = [self.curve_zero(), a, self.curve_double_gfp5(a)]
        for _ in range(3, 1 << window_bits):
            multiples.append(self.curve_add_gfp5(multiples[-1], a))
        return multiples

    def _scalar_windows(self, scalar, window_bits: int) -> list:
        """Little-endian window digit targets of a 10-u32-limb scalar."""
        bits = []
        for limb in scalar.value.limbs:
            bits.extend(self.split_le(limb, 32))
        return [self.le_sum(bits[i:i + window_bits])
                for i in range(0, len(bits), window_bits)]

    def curve_scalar_mul_gfp5(self, a: CurveTarget, scalar) -> CurveTarget:
        """Windowed double-and-add (reference: curve.rs:253-300, window 4)."""
        window = self.precompute_window_gfp5(a, 4)
        digits = self._scalar_windows(scalar, 4)
        result = self.curve_zero()
        for d in reversed(digits):
            for _ in range(4):
                result = self.curve_double_gfp5(result)
            addend = self.curve_random_access(d, window)
            result = self.curve_add_gfp5(result, addend)
        return result

    def precompute_window_const_gfp5(self, point: ec.WeierstrassPoint,
                                     window_bits: int) -> list:
        """Window of CONSTANT multiples [O, P, 2P, ..., (2^w-1)P] — the
        fixed-base analog of precompute_window_gfp5: the multiples are
        computed natively and enter the circuit as constants, saving the
        2^w-2 in-circuit point additions (reference: gadgets/curve.rs
        precompute_window_const:277-292 backed by the mul_table.rs
        precomputed windows)."""
        multiples = [self.curve_zero()]
        curr = point
        for _ in range(1, 1 << window_bits):
            multiples.append(self.curve_constant(curr))
            curr = curr.add(point)
        return multiples

    def curve_scalar_mul_const_gfp5(self, point: ec.WeierstrassPoint,
                                    scalar) -> CurveTarget:
        """Fixed-base windowed mul: the window is constant, only the
        doublings and additions are in-circuit (reference: gadgets/curve.rs
        curve_scalar_mul_const:294-316)."""
        window = self.precompute_window_const_gfp5(point, 4)
        digits = self._scalar_windows(scalar, 4)
        result = self.curve_zero()
        for d in reversed(digits):
            for _ in range(4):
                result = self.curve_double_gfp5(result)
            addend = self.curve_random_access(d, window)
            result = self.curve_add_gfp5(result, addend)
        return result

    def curve_muladd_2_gfp5(self, a, b: CurveTarget,
                            scalar_a, scalar_b) -> CurveTarget:
        """s_a*A + s_b*B with shared doublings (reference: curve.rs:366-420).
        When A is a native WeierstrassPoint (fixed base, e.g. the generator),
        its window enters as constants — the mul_table.rs fixed-base path."""
        if isinstance(a, ec.WeierstrassPoint):
            wa = self.precompute_window_const_gfp5(a, 4)
        else:
            wa = self.precompute_window_gfp5(a, 4)
        wb = self.precompute_window_gfp5(b, 4)
        da = self._scalar_windows(scalar_a, 4)
        db = self._scalar_windows(scalar_b, 4)
        result = self.curve_zero()
        for da_i, db_i in zip(reversed(da), reversed(db)):
            for _ in range(4):
                result = self.curve_double_gfp5(result)
            result = self.curve_add_gfp5(
                result, self.curve_random_access(da_i, wa))
            result = self.curve_add_gfp5(
                result, self.curve_random_access(db_i, wb))
        return result

    def curve_encode_to_quintic_ext(self, p: CurveTarget):
        """w = y / (a/3 - x); the neutral encodes to 0
        (reference: curve.rs curve_encode_to_quintic_ext)."""
        a_third = ref.extn_mul(ec.A_DO, ref.extn_inverse(
            (3, 0, 0, 0, 0), ec.W, ec.DTH_ROOT), ec.W)
        denom = self.sub_quintic_ext(self.constant_quintic_ext(a_third), p.x)
        w = self.div_or_zero_quintic_ext(p.y, denom)
        # force 0 for the neutral
        not_inf = self.not_(p.is_inf)
        return tuple(self.mul(not_inf, c) for c in w)


class _QuinticQuotientGenerator:
    def __init__(self, a, b, quotient):
        self.a, self.b, self.quotient = a, b, quotient

    def watch_list(self):
        return list(self.a) + list(self.b)

    def run(self, witness, out):
        if not all(witness.is_set(t) for t in self.watch_list()):
            return False
        a = tuple(witness.get(t) for t in self.a)
        b = tuple(witness.get(t) for t in self.b)
        if all(x == 0 for x in b):
            q = ec.GFP5_ZERO
        else:
            q = ref.extn_mul(a, ref.extn_inverse(b, ec.W, ec.DTH_ROOT), ec.W)
        for t, v in zip(self.quotient, q):
            out.append((t, v))
        return True


def set_quintic_ext_target(pw, t, value: tuple) -> None:
    for x, v in zip(t, value):
        pw.set_target(x, int(v))


def set_curve_target(pw, t: CurveTarget, p: ec.WeierstrassPoint) -> None:
    set_quintic_ext_target(pw, t.x, p.x)
    set_quintic_ext_target(pw, t.y, p.y)
    pw.set_target(t.is_inf, 1 if p.is_inf else 0)


def schnorr_verify_circuit(builder, message: list[int],
                           pk: ec.WeierstrassPoint,
                           sig: ec.SchnorrSignature) -> None:
    """In-circuit Schnorr verification with baked message/pk/sig constants
    (reference: gadgets/schnorr.rs:82-105)."""
    msg_targets = [builder.constant(m) for m in message]
    s = builder.constant_nonnative(sig.s, ec.N)
    e = builder.constant_nonnative(sig.e, ec.N)
    pk_t = builder.curve_constant(pk)
    # generator half rides the fixed-base constant window (mul_table analog)
    r_v = builder.curve_muladd_2_gfp5(ec.GENERATOR, pk_t, s, e)
    preimage = list(builder.curve_encode_to_quintic_ext(r_v)) + msg_targets
    e_v_ext = tuple(builder.hash_n_to_m_no_pad(preimage, 5))
    e_v = builder.encode_quintic_ext_as_scalar(e_v_ext)
    builder.connect_nonnative(e, e_v)
