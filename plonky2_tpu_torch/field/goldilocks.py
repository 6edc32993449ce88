"""Goldilocks field (p = 2^64 - 2^32 + 1) on int64 tensors.

A field array is one `torch.int64` tensor holding the canonical u64 bit
pattern, so it round-trips with numpy through `.view(np.uint64)`. Every
result is canonical (< p): the tests compare bit patterns.

PyTorch has no uint64 arithmetic, and int64 has two traps: `>>` sign-extends
and a 32x32 product leaves the signed range. So the arithmetic splits values
into 32-bit halves (masked after every shift) and multiplies 32-bit by 16-bit
pieces, which stay below 2^48. One reduction, `_reduce_lh`, takes any
L + H * 2^32 with 0 <= L, H < 2^62 to its canonical residue using
2^64 = 2^32 - 1 (mod p). That is the plain version (`add_plain`,
`mul_plain`, ...), which every op takes for a CPU tensor.

For a CUDA tensor each op is one launch of csrc/field.cu (`field_binary`),
which computes the same canonical values in registers: operands broadcast
by strides inside the kernel, and an operand that is one host value (a CPU
0-d tensor beside a CUDA one, a constant, an exponent) rides in the
kernel's arguments. The composite functions (`reduce_sum`, `powers`, ...)
are the same code on both devices.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import backend
from ..utils import timing as tracing
from . import reference as ref

ORDER = ref.ORDER
M32 = 0xFFFFFFFF
M16 = 0xFFFF
# csrc/field.cu: the op codes of its entries and the dims a plan can hold
BINARY_OPS = {"add": 0, "sub": 1, "mul": 2, "exp": 3, "reduce_lh": 4}
EXT_OPS = {"add": 0, "sub": 1, "mul": 2}
MAX_DIMS = 6


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


def _signed(v: int) -> int:
    """A u64 bit pattern as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def lead(*xs):
    """The operand whose device decides an op's path: the first tensor but a
    CPU 0-d one, which rides beside a CUDA operand by value, as PyTorch
    takes it (the first tensor, when all are)."""
    first = None
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.is_cuda or x.dim():
                return x
            if first is None:
                first = x
    return first


def plan(name: str, xs) -> tuple:
    """(device, output shape, plan) of one launch of csrc/field.cu.

    The output shape is the operands' broadcast shape. The plan, 64-bit
    words packed as bytes, is that shape with its size-1 dims dropped and
    neighbouring dims merged wherever every operand steps through them as
    one (at most MAX_DIMS left), then for each operand its pointer, its
    value and its element strides over those dims (0 on a broadcast dim).
    An int64 tensor on the lead's device is read through its pointer and
    strides, views included; a CPU 0-d int64 tensor or a python int (a u64
    pattern) travels by value with pointer 0. Raises on anything else."""
    device = lead(*xs).device
    tensors, words = [], []
    for x in xs:
        if isinstance(x, int):
            tensors.append(None)
            words.append((0, _signed(x)))
            continue
        if x.dtype != torch.int64:
            raise ValueError(f"{name}: needs int64 operands, got {x.dtype}")
        if x.device == device:
            tensors.append(x)
            words.append((x.data_ptr(), 0))
        elif x.device.type == "cpu" and not x.dim():
            tensors.append(None)
            words.append((0, int(x)))
        else:
            raise ValueError(f"{name}: an operand on {x.device} beside one "
                             f"on {device}")
    read = [x for x in tensors if x is not None]
    out = read[0].shape
    if all(x.shape == out and x.is_contiguous() for x in read):
        n = out.numel()        # the common case: one dim, unit strides
        dims = [n] if n != 1 else []
        strides = [[0 if x is None else 1 for x in tensors]] * len(dims)
    else:
        out, dims, strides = _merged(name, tensors)
        n = 1
        for size in dims:
            n *= size
    pad = MAX_DIMS - len(dims)
    w = [n, max(len(dims), 1)] + dims + [1] * pad
    for k, (ptr, value) in enumerate(words):
        w += [ptr, value] + [col[k] for col in strides] + [0] * pad
    return device, out, struct.pack(f"{len(w)}q", *w)


def _merged(name: str, tensors) -> tuple:
    """(broadcast shape, merged dims, strides [dim][operand]) of operands
    that are tensors or None (by value)."""
    nd = max(x.dim() for x in tensors if x is not None)
    out = [1] * nd
    cols = []
    for x in tensors:
        if x is None:
            cols.append(None)
            continue
        pad = nd - x.dim()
        col = [0] * nd
        for d, (size, st) in enumerate(zip(x.shape, x.stride()), pad):
            if size == 1:
                continue
            if out[d] == 1:
                out[d] = size
            elif out[d] != size:
                raise ValueError(f"{name}: shapes do not broadcast: "
                                 + ", ".join(str(tuple(t.shape)) for t in
                                             tensors if t is not None))
            col[d] = st
        cols.append(col)
    dims, strides = [], []
    for d, size in enumerate(out):
        if size == 1:
            continue
        col = [0 if c is None else c[d] for c in cols]
        if dims and all(s0 == s * size for s0, s in zip(strides[-1], col)):
            dims[-1] *= size
            strides[-1] = col
        else:
            dims.append(size)
            strides.append(col)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{name}: {len(dims)} dims after merging, above "
                         f"{MAX_DIMS}: shape {tuple(out)}")
    return torch.Size(out), dims, strides


def empty(xs, shape, device) -> torch.Tensor:
    """A new contiguous int64 output of `shape` on `device`: empty_like of
    a contiguous operand of that shape where there is one (measured on the
    card at 2 us a call against 8 for torch.empty of a shape)."""
    for x in xs:
        if (isinstance(x, torch.Tensor) and x.shape == shape
                and x.device == device and x.is_contiguous()):
            return torch.empty_like(x)
    return torch.empty(shape, dtype=torch.int64, device=device)


def _binary(name: str, a, b) -> torch.Tensor:
    """One launch of `field_binary` (op `name`) over a and b."""
    device, shape, words = plan(name, (a, b))
    out = empty((a, b), shape, device)
    if out.numel():
        backend.check(backend.call(
            "field_binary", out, BINARY_OPS[name], out.data_ptr(), words,
            backend.stream(out)), "field_binary")
        backend.KERNELS["field"].launched((name, tuple(shape)))
    return out


def add(a, b):
    if backend.plain_path(lead(a, b), "add"):
        return add_plain(a, b)
    return _binary("add", a, b)


def sub(a, b):
    if backend.plain_path(lead(a, b), "sub"):
        return sub_plain(a, b)
    return _binary("sub", a, b)


def neg(a):
    if backend.plain_path(a, "neg"):
        return neg_plain(a)
    return _binary("sub", 0, a)


def mul(a, b):
    if backend.plain_path(lead(a, b), "mul"):
        return mul_plain(a, b)
    return _binary("mul", a, b)


def reduce_lh(L, H):
    """(L + H * 2^32) mod p for 0 <= L, H < 2^62, canonical."""
    if backend.plain_path(lead(L, H), "reduce_lh"):
        return _reduce_lh(L, H)
    return _binary("reduce_lh", L, H)


def add_plain(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce_lh(a0 + b0, a1 + b1)


def sub_plain(a, b):
    # + 2p = (2 + 2^32) + (2^33 - 3) * 2^32 keeps both halves non-negative
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    return _reduce_lh(a0 - b0 + (2 + (1 << 32)), a1 - b1 + ((1 << 33) - 3))


def neg_plain(a):
    return sub_plain(torch.zeros_like(a), a)


def mul_plain(a, b):
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
    if backend.plain_path(a, "mul_small"):
        return mul_small_plain(a, c)
    return _binary("mul", a, c)


def mul_small_plain(a, c: int):
    assert 0 <= c < 1 << 30
    a0, a1 = _split(a)
    return _reduce_lh(a0 * c, a1 * c)


def mat_small(m, s):
    """Matrix of small constants m [R, C, 1] (0 <= m < 2^20) times lanes
    s [C, N] -> [R, N]: 32-bit half sums, one reduction."""
    lo, hi = _split(s)
    return reduce_lh((m * lo.unsqueeze(0)).sum(1),
                     (m * hi.unsqueeze(0)).sum(1))


def mul_const(a, c: int):
    if backend.plain_path(a, "mul_const"):
        return mul_const_plain(a, c)
    return _binary("mul", a, c % ORDER)


def mul_const_plain(a, c: int):
    c %= ORDER
    if c < 1 << 30:
        return mul_small_plain(a, c)
    return mul_plain(a, const(c, a.device))


def add_const(a, c: int):
    if backend.plain_path(a, "add_const"):
        return add_const_plain(a, c)
    return _binary("add", a, c % ORDER)


def add_const_plain(a, c: int):
    return add_plain(a, const(c, a.device))


def reduce_sum(a, dim: int = 0):
    """Field sum along `dim` (up to 2^30 terms)."""
    a0, a1 = _split(a)
    return reduce_lh(a0.sum(dim), a1.sum(dim))


def prefix_sum(a):
    """Inclusive prefix sums along the last axis (up to 2^30 terms): the
    32-bit halves are summed exactly in int64, then reduced once."""
    lo, hi = _split(a)
    return reduce_lh(lo.cumsum(-1), hi.cumsum(-1))


def suffix_sum(a):
    """s_i = sum_{j >= i} a_j along the last axis (up to 2^30 terms)."""
    return prefix_sum(a.flip(-1)).flip(-1)


def exp(a, e: int):
    """a^e for a python-int exponent 0 <= e < 2^64 (a^0 = 1)."""
    if backend.plain_path(a, "exp"):
        return exp_plain(a, e)
    if not 0 <= e < 1 << 64:
        raise ValueError(f"exp: exponent {e} outside [0, 2^64)")
    return _binary("exp", a, e)


def exp_plain(a, e: int):
    """Square-and-multiply."""
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul_plain(result, base)
        e >>= 1
        if e:
            base = mul_plain(base, base)
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
