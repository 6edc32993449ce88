"""EcGFp5 scalar field — arithmetic modulo the group order n (~2^319).

Reference: ecgfp5/src/curve/scalar_field.rs (Scalar over five u64 limbs with
Montgomery multiplication, encode/decode over 40 bytes, from_gfp5 :465,
from_hashout :470, recode_signed :531-577). The reference needs constant-time
limb arithmetic because scalars are secrets on the signing path; here scalar
work is host control flow for circuit construction and tests, so scalars are
Python ints (exact), with the reference's API surface and byte formats.
"""

from __future__ import annotations

import secrets

# group order n (reference: scalar_field.rs:279-285, little-endian u64 limbs)
N = sum(x << (64 * i) for i, x in enumerate([
    0xE80FD996948BFFE1,
    0xE8885C39D724A09C,
    0x7FFFFFE6CFB80639,
    0x7FFFFFF100000016,
    0x7FFFFFFD80000007,
]))

NUM_BYTES = 40          # ceil(319 / 8) rounded to the 5-limb encoding
ORDER_GL = (1 << 64) - (1 << 32) + 1


class Scalar:
    """Immutable scalar mod n. Value is always canonical (0 <= v < n)."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        object.__setattr__(self, "v", v % N)

    def __setattr__(self, *a):  # immutability guard
        raise AttributeError("Scalar is immutable")

    # -- constants ----------------------------------------------------------
    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    @staticmethod
    def one() -> "Scalar":
        return Scalar(1)

    @staticmethod
    def sample() -> "Scalar":
        return Scalar(secrets.randbelow(N))

    # -- ring ops (reference Add/Sub/Neg/Mul/Div impls) ----------------------
    def __add__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v + o.v)

    def __sub__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v - o.v)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.v)

    def __mul__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v * o.v)

    def square(self) -> "Scalar":
        return Scalar(self.v * self.v)

    def double(self) -> "Scalar":
        return Scalar(self.v << 1)

    def inverse(self) -> "Scalar":
        """Multiplicative inverse; inverse of 0 is 0 (matches the
        reference's try_inverse().unwrap_or(ZERO) usage)."""
        if self.v == 0:
            return Scalar(0)
        return Scalar(pow(self.v, -1, N))

    def __truediv__(self, o: "Scalar") -> "Scalar":
        return self * o.inverse()

    def exp(self, e: int) -> "Scalar":
        return Scalar(pow(self.v, e, N))

    def __eq__(self, o) -> bool:
        return isinstance(o, Scalar) and self.v == o.v

    def __hash__(self) -> int:
        return hash(("ecgfp5-scalar", self.v))

    def __repr__(self) -> str:
        return f"Scalar({self.v:#x})"

    def is_zero(self) -> bool:
        return self.v == 0

    # -- encodings (reference scalar_field.rs:437-530) -----------------------
    def encode(self) -> bytes:
        """Exactly 40 little-endian bytes (reference encode :521)."""
        return self.v.to_bytes(NUM_BYTES, "little")

    def limbs_u64(self) -> list[int]:
        return [(self.v >> (64 * i)) & ((1 << 64) - 1) for i in range(5)]

    @staticmethod
    def from_canonical_bytes(buf: bytes) -> "Scalar | None":
        """Decode 40 bytes; None if the value is >= n
        (reference from_canonical_bytes :511)."""
        if len(buf) != NUM_BYTES:
            return None
        v = int.from_bytes(buf, "little")
        return Scalar(v) if v < N else None

    @staticmethod
    def from_noncanonical_bytes(buf: bytes) -> "Scalar":
        """Arbitrary-length little-endian bytes, reduced mod n
        (reference from_noncanonical_bytes :481)."""
        return Scalar(int.from_bytes(buf, "little"))

    @staticmethod
    def from_noncanonical_biguint(v: int) -> "Scalar":
        return Scalar(v)

    @staticmethod
    def from_gfp5(x: tuple) -> "Scalar":
        """GF(p^5) element (5 canonical Goldilocks limbs) interpreted as
        sum x_i 2^(64 i), reduced mod n (reference from_gfp5 :465)."""
        return Scalar(sum((xi % ORDER_GL) << (64 * i)
                          for i, xi in enumerate(x)))

    @staticmethod
    def from_hashout(elements: tuple) -> "Scalar":
        """4-element Poseidon digest -> scalar via the GF(p^5) embedding with
        a zero low limb (reference from_hashout :470)."""
        return Scalar.from_gfp5((0,) + tuple(elements))

    # -- signed recoding for windowed multiplication --------------------------
    def recode_signed(self, num_digits: int, w: int) -> list[int]:
        """Signed w-bit windows with value = sum d_i 2^(w i). All digits
        except the last lie in [-2^(w-1), 2^(w-1)); the last is the raw
        nonnegative remainder (up to 2^(w-1) when w*num_digits == 320 —
        the reference's "-(2^w-1) to +2^w" comment, recode_signed
        :531-577, which skips the sign adjustment on the top digit)."""
        assert 2 <= w <= 10
        digits = []
        acc = self.v
        for i in range(num_digits):
            if i == num_digits - 1:
                digits.append(acc)
                acc = 0
                break
            d = acc & ((1 << w) - 1)
            if d >= (1 << (w - 1)):
                d -= 1 << w
            digits.append(d)
            acc = (acc - d) >> w
        assert acc == 0, "num_digits too small for a 319-bit scalar"
        assert digits[-1] < (1 << w), "top digit overflow"
        return digits
