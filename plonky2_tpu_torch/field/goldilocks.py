"""Goldilocks field (p = 2^64 - 2^32 + 1) on int64 tensors.

A field array is one `torch.int64` tensor holding the canonical u64 bit
pattern, so it round-trips with numpy through `.view(np.uint64)`. Every
result is canonical (< p): the tests compare bit patterns.

PyTorch has no uint64 arithmetic, and int64 has two traps: `>>` sign-extends
and a 32x32 product leaves the signed range. So the arithmetic splits values
into 32-bit halves (masked after every shift) and multiplies 32-bit by 16-bit
pieces, which stay below 2^48. One reduction, `_reduce_lh`, takes any
L + H * 2^32 with 0 <= L, H < 2^62 to its canonical residue using
2^64 = 2^32 - 1 (mod p). The same code runs on CPU and CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing as tracing
from . import reference as ref

ORDER = ref.ORDER
M32 = 0xFFFFFFFF
M16 = 0xFFFF


def from_u64(x, device) -> torch.Tensor:
    """numpy uint64 array or (nested) python ints -> canonical int64 tensor."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        arr = np.where(x >= np.uint64(ORDER), x - np.uint64(ORDER), x)
    else:
        arr = np.vectorize(lambda v: int(v) % ORDER, otypes=[np.uint64])(
            np.asarray(x, dtype=object))
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    tracing.count("host_reads")      # a blocking upload drains the queue
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    tracing.count("host_reads")
    return a.detach().cpu().numpy().view(np.uint64).copy()


def to_ints(a: torch.Tensor) -> list:
    return [int(v) for v in to_u64(a).reshape(-1)]


def const(c: int, device, shape=()) -> torch.Tensor:
    v = c % ORDER
    v = v - (1 << 64) if v >= 1 << 63 else v
    return torch.full(shape, v, dtype=torch.int64, device=device)


def _split(a):
    return a & M32, (a >> 32) & M32


def _canonical(lo, hi):
    """lo, hi in [0, 2^32), value < 2^64 -> canonical pattern."""
    over = (hi == M32) & (lo != 0)          # value >= p: value - p = lo - 1
    return torch.where(over, lo - 1, (hi << 32) | lo)


def _reduce_lh(L, H):
    """(L + H * 2^32) mod p for 0 <= L, H < 2^62."""
    H = H + (L >> 32)
    L = L & M32
    q = H >> 32                              # q * 2^64 == q * (2^32 - 1)
    H = (H & M32) + q
    L = L - q
    H = H + (L >> 32)                        # borrow
    L = L & M32
    q = H >> 32                              # q in {0, 1}
    H = (H & M32) + q
    L = L - q
    H = H + (L >> 32)
    L = L & M32
    return _canonical(L, H)


def _mul32(x, y):
    """x, y in [0, 2^32) -> (lo, hi) 32-bit halves of x * y."""
    t0 = x * (y & M16)                       # < 2^48
    t1 = x * (y >> 16)                       # < 2^48
    lo = (t0 & M32) + ((t1 & M16) << 16)     # < 2^33
    hi = (t0 >> 32) + (t1 >> 16) + (lo >> 32)
    return lo & M32, hi


def add(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce_lh(a0 + b0, a1 + b1)


def sub(a, b):
    # + 2p = (2 + 2^32) + (2^33 - 3) * 2^32 keeps both halves non-negative
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce_lh(a0 - b0 + (2 + (1 << 32)), a1 - b1 + ((1 << 33) - 3))


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    ll0, ll1 = _mul32(a0, b0)
    lh0, lh1 = _mul32(a0, b1)
    hl0, hl1 = _mul32(a1, b0)
    hh0, hh1 = _mul32(a1, b1)
    c1 = ll1 + lh0 + hl0                     # 32-bit columns of the product
    c2 = lh1 + hl1 + hh0
    # c0 + c1 2^32 + c2 2^64 + hh1 2^96 == (c0 - c2 - hh1) + (c1 + c2) 2^32;
    # + 4p = (4 + 2^34) + (2^34 - 8) * 2^32 keeps both halves non-negative
    return _reduce_lh(ll0 - c2 - hh1 + (4 + (1 << 34)),
                      c1 + c2 + ((1 << 34) - 8))


def square(a):
    return mul(a, a)


def mul_small(a, c: int):
    """a * c for a constant 0 <= c < 2^30."""
    assert 0 <= c < 1 << 30
    a0, a1 = _split(a)
    return _reduce_lh(a0 * c, a1 * c)


def mat_small(m, s):
    """Matrix of small constants m [R, C, 1] (0 <= m < 2^20) times lanes
    s [C, N] -> [R, N]: 32-bit half sums, one reduction."""
    lo, hi = _split(s)
    return _reduce_lh((m * lo.unsqueeze(0)).sum(1),
                      (m * hi.unsqueeze(0)).sum(1))


def mul_const(a, c: int):
    c %= ORDER
    if c < 1 << 30:
        return mul_small(a, c)
    return mul(a, const(c, a.device))


def add_const(a, c: int):
    return add(a, const(c, a.device))


def reduce_sum(a, dim: int = 0):
    """Field sum along `dim` (up to 2^30 terms)."""
    a0, a1 = _split(a)
    return _reduce_lh(a0.sum(dim), a1.sum(dim))


def prefix_sum(a):
    """Inclusive prefix sums along the last axis (up to 2^30 terms): the
    32-bit halves are summed exactly in int64, then reduced once."""
    lo, hi = _split(a)
    return _reduce_lh(lo.cumsum(-1), hi.cumsum(-1))


def suffix_sum(a):
    """s_i = sum_{j >= i} a_j along the last axis (up to 2^30 terms)."""
    return prefix_sum(a.flip(-1)).flip(-1)


def exp(a, e: int):
    """a^e for a python-int exponent, square-and-multiply."""
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inverse(a):
    """Elementwise inverse a^(p-2) over the whole tensor (0 -> 0)."""
    return exp(a, ORDER - 2)


def powers(base: int, n: int, device) -> torch.Tensor:
    """[base^0, ..., base^{n-1}] by log-doubling."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    base %= ORDER
    while out.shape[0] < n:
        k = out.shape[0]
        out = torch.cat([out, mul_const(out, ref.exp(base, k))])
    return out[:n]


def prod_scan_exclusive(x):
    """Exclusive prefix products along the last axis (log-step scan)."""
    y = x
    d = 1
    n = x.shape[-1]
    while d < n:
        y = torch.cat([y[..., :d], mul(y[..., d:], y[..., :-d])], dim=-1)
        d *= 2
    return torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], dim=-1)
