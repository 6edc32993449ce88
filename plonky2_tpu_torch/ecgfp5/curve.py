"""Native EcGFp5 curve arithmetic in short Weierstrass form over GF(p^5),
plus Schnorr signatures.

Reference: ecgfp5/src/curve/curve.rs — WeierstrassPoint (:47-120, curve
constants A/B :55-70, GENERATOR :73-90, encode :92-94), Point double-odd
internals (:140-560 — here replaced by plain Weierstrass formulas, which
agree on the group law); scalar_field.rs (group order n, from_gfp5 :465);
gadgets/schnorr.rs (sign :48-67, verify :69-80, hash :112-118).

Elements of GF(p^5) are 5-tuples of python ints; arithmetic comes from the
generic OEF helpers (field/reference.py, W=3).
"""

from __future__ import annotations

import dataclasses
import functools
import secrets

from ..field import reference as ref

W = ref.EXT5_W
DTH_ROOT = ref.EXT5_DTH_ROOT

GFP5_ZERO = (0, 0, 0, 0, 0)
GFP5_ONE = (1, 0, 0, 0, 0)

# Weierstrass curve constants (reference: curve.rs:55-70)
A = (6148914689804861439, 263, 0, 0, 0)
B = (15713893096167979237, 6148914689804861265, 0, 0, 0)
# double-odd form a constant (used by point encoding, curve.rs:92-94,:145)
A_DO = (2, 0, 0, 0, 0)

GENERATOR_X = (11712523173042564207, 14090224426659529053,
               13197813503519687414, 16280770174934269299,
               15998333998318935536)
GENERATOR_Y = (14639054205878357578, 17426078571020221072,
               2548978194165003307, 8663895577921260088,
               9793640284382595140)

# group order n (reference: scalar_field.rs order(), little-endian u32s)
N = sum(x << (32 * i) for i, x in enumerate([
    0x948BFFE1, 0xE80FD996, 0xD724A09C, 0xE8885C39, 0xCFB80639,
    0x7FFFFFE6, 0x00000016, 0x7FFFFFF1, 0x80000007, 0x7FFFFFFD]))


def _mul(a, b):
    return ref.extn_mul(a, b, W)


def _inv(a):
    return ref.extn_inverse(a, W, DTH_ROOT)


@dataclasses.dataclass(frozen=True)
class WeierstrassPoint:
    x: tuple
    y: tuple
    is_inf: bool = False

    def is_valid(self) -> bool:
        if self.is_inf:
            return True
        y2 = _mul(self.y, self.y)
        x3 = _mul(_mul(self.x, self.x), self.x)
        rhs = ref.extn_add(ref.extn_add(x3, _mul(A, self.x)), B)
        return y2 == rhs

    def neg(self) -> "WeierstrassPoint":
        if self.is_inf:
            return self
        return WeierstrassPoint(self.x, ref.extn_neg(self.y))

    def double(self) -> "WeierstrassPoint":
        if self.is_inf or self.y == GFP5_ZERO:
            return NEUTRAL
        x2 = _mul(self.x, self.x)
        num = ref.extn_add(ref.extn_add(ref.extn_add(x2, x2), x2), A)
        lam = _mul(num, _inv(ref.extn_add(self.y, self.y)))
        x3 = ref.extn_sub(_mul(lam, lam), ref.extn_add(self.x, self.x))
        y3 = ref.extn_sub(_mul(lam, ref.extn_sub(self.x, x3)), self.y)
        return WeierstrassPoint(x3, y3)

    def add(self, other: "WeierstrassPoint") -> "WeierstrassPoint":
        if self.is_inf:
            return other
        if other.is_inf:
            return self
        if self.x == other.x:
            if ref.extn_add(self.y, other.y) == GFP5_ZERO:
                return NEUTRAL
            return self.double()
        lam = _mul(ref.extn_sub(other.y, self.y),
                   _inv(ref.extn_sub(other.x, self.x)))
        x3 = ref.extn_sub(_mul(lam, lam), ref.extn_add(self.x, other.x))
        y3 = ref.extn_sub(_mul(lam, ref.extn_sub(self.x, x3)), self.y)
        return WeierstrassPoint(x3, y3)

    def mul(self, k: int) -> "WeierstrassPoint":
        k %= N
        result = NEUTRAL
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result

    def encode(self) -> tuple:
        """w = y / (a/3 - x) with a the double-odd constant; the neutral
        encodes to 0 (reference: curve.rs:92-94,:200-205)."""
        if self.is_inf:
            return GFP5_ZERO
        a_third = _mul(A_DO, _inv((3, 0, 0, 0, 0)))
        return _mul(self.y, _inv(ref.extn_sub(a_third, self.x)))


NEUTRAL = WeierstrassPoint(GFP5_ZERO, GFP5_ZERO, is_inf=True)
GENERATOR = WeierstrassPoint(GENERATOR_X, GENERATOR_Y)


def scalar_from_gfp5(x: tuple) -> int:
    """sum x_i 2^(64 i) mod n (reference: scalar_field.rs:465-468)."""
    return sum(int(c) << (64 * i) for i, c in enumerate(x)) % N


# ---------------------------------------------------------------------------
# Fixed-base multiplication of the generator
# (reference: curve/mul_table.rs — 8 tables of 16 affine points
#  Gk[i] = (i+1) * 2^(40k) * G; curve.rs mulgen:536-560 — 5-bit signed
#  windows, 8 table lookups per window position, 5 doublings between
#  positions. The reference bakes the 2,132-LoC tables into the binary;
#  here they are computed once at first use and cached.)
# ---------------------------------------------------------------------------

MULGEN_WINDOW_BITS = 5
MULGEN_NUM_TABLES = 8           # one per 40-bit span of the 320-bit scalar
MULGEN_DIGITS = 64              # 320 / 5


@functools.lru_cache(maxsize=1)
def mulgen_tables() -> tuple:
    """8 tables of 16 points: tables[j][i] = (i+1) * 2^(40 j) * G."""
    tables = []
    for j in range(MULGEN_NUM_TABLES):
        base = GENERATOR.mul(pow(2, 40 * j, N))
        row = [base]
        for _ in range(15):
            row.append(row[-1].add(base))
        tables.append(tuple(row))
    return tuple(tables)


def _lookup_signed(table: tuple, digit: int) -> WeierstrassPoint:
    """table[|d|-1] negated when d < 0; the zero digit is the neutral
    (reference: curve.rs AffinePoint::lookup)."""
    if digit == 0:
        return NEUTRAL
    p = table[abs(digit) - 1]
    return p.neg() if digit < 0 else p


def mulgen(k: int) -> WeierstrassPoint:
    """k * G via the fixed-base window tables (reference curve.rs:536-560);
    ~35 doublings + 64 table additions instead of ~320 + ~160."""
    from .scalar_field import Scalar
    digits = Scalar(k).recode_signed(MULGEN_DIGITS, MULGEN_WINDOW_BITS)
    tables = mulgen_tables()
    p = _lookup_signed(tables[0], digits[7])
    for j in range(1, MULGEN_NUM_TABLES):
        p = p.add(_lookup_signed(tables[j], digits[8 * j + 7]))
    for i in range(6, -1, -1):
        for _ in range(MULGEN_WINDOW_BITS):
            p = p.double()
        for j in range(MULGEN_NUM_TABLES):
            p = p.add(_lookup_signed(tables[j], digits[8 * j + i]))
    return p


# ---------------------------------------------------------------------------
# Schnorr (reference: gadgets/schnorr.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchnorrSignature:
    s: int
    e: int


def _hash5(message: list[int]) -> tuple:
    """hash_n_to_m_no_pad(message, 5) under Poseidon: five outputs fit in
    one squeeze of the rate (reference: schnorr.rs:112-118)."""
    from ..hash.poseidon import permute_host
    from ..hash.sponge import SPONGE_RATE, W
    state = [0] * W
    for start in range(0, len(message), SPONGE_RATE):
        chunk = [x % ref.ORDER for x in message[start:start + SPONGE_RATE]]
        state[:len(chunk)] = chunk
        state = permute_host(state)
    return tuple(state[:5])


def schnorr_keygen(sk: int | None = None):
    sk = sk if sk is not None else secrets.randbelow(N - 1) + 1
    return GENERATOR.mul(sk), sk


def schnorr_sign(message: list[int], sk: int,
                 k: int | None = None) -> SchnorrSignature:
    k = k if k is not None else secrets.randbelow(N - 1) + 1
    r = GENERATOR.mul(k)
    preimage = list(r.encode()) + list(message)
    e = scalar_from_gfp5(_hash5(preimage))
    s = (k - e * sk) % N
    return SchnorrSignature(s, e)


def schnorr_verify(message: list[int], pk: WeierstrassPoint,
                   sig: SchnorrSignature) -> bool:
    r = GENERATOR.mul(sig.s).add(pk.mul(sig.e))
    preimage = list(r.encode()) + list(message)
    e = scalar_from_gfp5(_hash5(preimage))
    return e == sig.e
