"""Native (host-side) secp256k1 curve arithmetic and ECDSA.

Reference: ecdsa/src/curve/ — curve_types.rs (AffinePoint:47, ProjectivePoint
:123, Weierstrass add/double), secp256k1.rs (curve constants),
glv.rs (GLV endomorphism decomposition :41-98), curve_msm.rs (windowed MSM),
ecdsa.rs (sign_message:27, verify_message:44); field/src/secp256k1_base.rs,
secp256k1_scalar.rs (field parameters).

Host python-int arithmetic: this layer backs witness generation, the
tests' oracle and standalone signing; `curve_gadgets.py` is the provable
surface.
"""

from __future__ import annotations

import dataclasses
import secrets

# secp256k1 parameters (public standard, SEC 2)
P = 2**256 - 2**32 - 977    # base field
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141  # scalar
A = 0
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# GLV endomorphism (reference: glv.rs:14-35; limb arrays -> ints)
GLV_BETA = sum(x << (64 * i) for i, x in enumerate([
    13923278643952681454, 11308619431505398165,
    7954561588662645993, 8856726876819556112]))
GLV_S = sum(x << (64 * i) for i, x in enumerate([
    16069571880186789234, 1310022930574435960,
    11900229862571533402, 6008836872998760672]))
_A1 = 16747920425669159701 + (3496713202691238861 << 64)
_MINUS_B1 = 8022177200260244675 + (16448129721693014056 << 64)
_A2 = 6323353552219852760 + (1498098850674701302 << 64) + (1 << 128)
_B2 = _A1


@dataclasses.dataclass(frozen=True)
class AffinePoint:
    x: int
    y: int
    zero: bool = False

    def is_valid(self) -> bool:
        if self.zero:
            return True
        return (self.y * self.y - (pow(self.x, 3, P) + A * self.x + B)) % P == 0

    def neg(self) -> "AffinePoint":
        if self.zero:
            return self
        return AffinePoint(self.x, (-self.y) % P)

    def double(self) -> "AffinePoint":
        if self.zero:
            return self
        lam = (3 * self.x * self.x + A) * pow(2 * self.y, P - 2, P) % P
        x3 = (lam * lam - 2 * self.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return AffinePoint(x3, y3)

    def add(self, other: "AffinePoint") -> "AffinePoint":
        if self.zero:
            return other
        if other.zero:
            return self
        if self.x == other.x:
            if (self.y + other.y) % P == 0:
                return ZERO
            return self.double()
        lam = (other.y - self.y) * pow(other.x - self.x, P - 2, P) % P
        x3 = (lam * lam - self.x - other.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return AffinePoint(x3, y3)

    def mul(self, k: int) -> "AffinePoint":
        k %= N
        result = ZERO
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result


ZERO = AffinePoint(0, 0, zero=True)
GENERATOR = AffinePoint(GX, GY)


def msm(scalars: list[int], points: list[AffinePoint],
        w: int = 5) -> AffinePoint:
    """Windowed multi-scalar multiplication (reference: curve_msm.rs
    msm_parallel — digits processed MSB-first with shared doublings)."""
    assert len(scalars) == len(points)
    digits_list = []
    max_digits = 0
    for s in scalars:
        s %= N
        digits = []
        while s:
            digits.append(s & ((1 << w) - 1))
            s >>= w
        digits_list.append(digits)
        max_digits = max(max_digits, len(digits))
    # precompute small multiples per point
    tables = [[ZERO] for _ in points]
    for t, p in zip(tables, points):
        for _ in range(1, 1 << w):
            t.append(t[-1].add(p))
    acc = ZERO
    for d in range(max_digits - 1, -1, -1):
        for _ in range(w):
            acc = acc.double()
        for digits, table in zip(digits_list, tables):
            if d < len(digits) and digits[d]:
                acc = acc.add(table[digits[d]])
    return acc


def decompose_secp256k1_scalar(k: int):
    """GLV decomposition: |k1|, |k2| ~ sqrt(n) with k1 + s*k2 = k (mod n)
    (reference: glv.rs:41-75, HEHCC Alg 15.41)."""
    k %= N

    def round_ratio(num, den):
        return (2 * num + den) // (2 * den)

    c1 = round_ratio(_B2 * k, N) % N
    c2 = round_ratio(_MINUS_B1 * k, N) % N
    k1_raw = (k - c1 * _A1 - c2 * _A2) % N
    k2_raw = (c1 * _MINUS_B1 - c2 * _B2) % N
    assert (k1_raw + GLV_S * k2_raw) % N == k
    k1_neg = k1_raw > N // 2
    k1 = N - k1_raw if k1_neg else k1_raw
    k2_neg = k2_raw > N // 2
    k2 = N - k2_raw if k2_neg else k2_raw
    return k1, k2, k1_neg, k2_neg


def glv_mul(p: AffinePoint, k: int) -> AffinePoint:
    """k*P = k1*P + k2*psi(P), psi: (x,y) -> (beta*x, y)
    (reference: glv.rs:80-98)."""
    k1, k2, k1_neg, k2_neg = decompose_secp256k1_scalar(k)
    sp = AffinePoint(p.x * GLV_BETA % P, p.y, p.zero)
    first = p.neg() if k1_neg else p
    second = sp.neg() if k2_neg else sp
    return msm([k1, k2], [first, second])


# ---------------------------------------------------------------------------
# ECDSA (reference: ecdsa/src/curve/ecdsa.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ECDSASignature:
    r: int
    s: int


@dataclasses.dataclass(frozen=True)
class ECDSASecretKey:
    sk: int

    def to_public(self) -> "ECDSAPublicKey":
        return ECDSAPublicKey(GENERATOR.mul(self.sk))


@dataclasses.dataclass(frozen=True)
class ECDSAPublicKey:
    point: AffinePoint


def sign_message(msg: int, sk: ECDSASecretKey,
                 k: int | None = None) -> ECDSASignature:
    """reference: ecdsa.rs:27-42 (random nonce unless supplied)."""
    msg %= N
    while True:
        kk = k if k is not None else secrets.randbelow(N - 1) + 1
        rr = GENERATOR.mul(kk)
        if rr.x % N == 0:
            assert k is None, "bad supplied nonce"
            continue
        r = rr.x % N
        s = pow(kk, N - 2, N) * (msg + r * sk.sk) % N
        return ECDSASignature(r, s)


def verify_message(msg: int, sig: ECDSASignature,
                   pk: ECDSAPublicKey) -> bool:
    """reference: ecdsa.rs:44-64."""
    msg %= N
    assert pk.point.is_valid()
    c = pow(sig.s, N - 2, N)
    u1 = msg * c % N
    u2 = sig.r * c % N
    point = msm([u1, u2], [GENERATOR, pk.point])
    return sig.r == point.x % N
