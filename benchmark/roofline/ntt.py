"""K1, the NTT (`csrc/ntt.cu` under `ops/ntt.py`): the work one call needs.

A call's shape, as the kernel record gives it, is (rows, lg_n, rate_bits,
direction, shift): rows transforms of n = 2^lg_n points, to N = n 2^rate_bits
points for a forward low-degree extension. Bytes: each input read once and
each output written once, 8 (rows n + rows N); the twiddles and the shift or
scale powers can be made on chip, so they are not counted. Field
multiplies: one a butterfly of the lg_n stages not skipped (N / 2 each),
and one per input element shifted (a coset) or scaled (an inverse).
Bound: bytes at every shape of the proofs measured here.
"""

KERNEL = "ntt"
TRACE_NAMES = r"\bntt_(row|tiles|columns)\b"


def work(shape) -> tuple[float, float]:
    rows, lg_n, rate_bits, direction, shift = shape
    n, big_n = 1 << lg_n, 1 << (lg_n + rate_bits)
    scaled = shift is not None or direction == "inverse"
    nbytes = 8 * (rows * n + rows * big_n)
    muls = rows * (lg_n * (big_n // 2) + (n if scaled else 0))
    return nbytes, muls
