"""The port's Goldilocks and quadratic-extension arithmetic
(plonky2_tpu_torch/field) against field/reference.py and the JAX GF/GF2,
bit for bit, on seeded random values and the edges 0, 1, p-1, 2^32-1, 2^32
and EPSILON. Tolerance: exact (integer arithmetic mod p)."""

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.extension import gf2_powers as j_gf2_powers
from plonky2_tpu.field.goldilocks import GF, gf_powers
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.extension import GF2, gf2_powers

P = ref.ORDER
EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, ref.EPSILON]


def _operands():
    rng = np.random.default_rng(11)
    a = rng.integers(0, P, 300, dtype=np.uint64)
    b = rng.integers(0, P, 300, dtype=np.uint64)
    ea = np.repeat(np.asarray(EDGES, dtype=np.uint64), len(EDGES))
    eb = np.tile(np.asarray(EDGES, dtype=np.uint64), len(EDGES))
    return np.concatenate([a, ea]), np.concatenate([b, eb])


A, B = _operands()
TA, TB = gl.from_u64(A, "cpu"), gl.from_u64(B, "cpu")


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_op(name):
    py = {"add": ref.add, "sub": ref.sub, "mul": ref.mul}[name]
    jax_op = {"add": GF.__add__, "sub": GF.__sub__, "mul": GF.__mul__}[name]
    got = gl.to_u64(getattr(gl, name)(TA, TB))
    want = np.asarray([py(int(x), int(y)) for x, y in zip(A, B)],
                      dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_op(GF.from_u64(A), GF.from_u64(B)).to_u64())


@pytest.mark.parametrize("name", ["square", "neg", "mul_small", "exp",
                                  "inverse"])
def test_unary_op(name):
    ours = {"square": gl.square, "neg": gl.neg,
            "mul_small": lambda a: gl.mul_small(a, 41),
            "exp": lambda a: gl.exp(a, 7), "inverse": gl.inverse}[name]
    theirs = {"square": GF.square, "neg": GF.__neg__,
              "mul_small": lambda a: a.mul_small(41),
              "exp": lambda a: a.exp(7), "inverse": GF.inverse}[name]
    py = {"square": lambda x: ref.mul(x, x), "neg": ref.neg,
          "mul_small": lambda x: ref.mul(x, 41),
          "exp": lambda x: ref.exp(x, 7),
          "inverse": lambda x: ref.inverse(x) if x else 0}[name]
    got = gl.to_u64(ours(TA))
    np.testing.assert_array_equal(
        got, np.asarray([py(int(x)) for x in A], dtype=np.uint64))
    np.testing.assert_array_equal(got, theirs(GF.from_u64(A)).to_u64())


def test_mul_small_and_const_ranges():
    for c in (0, 1, (1 << 30) - 1, 1 << 30, 2**32 - 1, P - 1):
        want = [ref.mul(int(x), c) for x in A]
        assert gl.to_ints(gl.mul_const(TA, c)) == want


def test_u64_round_trip_reduces():
    raw = np.asarray([P, P + 5, 2**64 - 1, 0, P - 1], dtype=np.uint64)
    t = gl.from_u64(raw, "cpu")
    assert gl.to_ints(t) == [int(x) % P for x in raw]
    assert gl.to_ints(gl.from_u64([P + 3, -1, 7], "cpu")) == [3, P - 1, 7]


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_powers_and_sum(n):
    got = gl.to_ints(gl.powers(7, n, "cpu"))
    assert got == [ref.exp(7, i) for i in range(n)]
    assert got == [int(x) for x in gf_powers(GF.const(7), n).to_u64()]
    assert gl.to_ints(gl.reduce_sum(gl.powers(7, n, "cpu"))) == \
        [sum(got) % P]


def test_prod_scan_exclusive():
    x = TA[:100]
    acc, want = 1, []
    for v in A[:100]:
        want.append(acc)
        acc = ref.mul(acc, int(v))
    assert gl.to_ints(gl.prod_scan_exclusive(x)) == want


def test_gf2_mul_and_powers():
    a = GF2(TA, TB)
    b = GF2(TB, gl.add(TA, TB))
    got = (a * b).to_pairs()
    ja = JGF2(GF.from_u64(A), GF.from_u64(B))
    jb = JGF2(GF.from_u64(B), GF.from_u64(B) + GF.from_u64(A))
    c0, c1 = (ja * jb).to_u64_pair()
    assert got == [(int(x), int(y)) for x, y in zip(c0, c1)]
    assert got == [ref.ext2_mul(x, y)
                   for x, y in zip(a.to_pairs(), b.to_pairs())]
    z = (int(A[3]), int(A[4]))
    want = [ref.ext2_exp(z, i) for i in range(37)]
    assert gf2_powers(z, 37, "cpu").to_pairs() == want
    p0, p1 = j_gf2_powers(JGF2.const(*z), 37).to_u64_pair()
    assert want == [(int(x), int(y)) for x, y in zip(p0, p1)]


# --- the CUDA path (csrc/field.cu) ------------------------------------------
# Its kernels run only on the card (chip_smoke.py's `field` phase holds them
# against the plain version there). Here: the dispatch rule, the wrapper's
# plan read back the way the kernel reads it, the wrappers end to end with
# the kernel's call emulated on CPU memory, and a python-int model of each
# kernel's arithmetic on the lazy-arithmetic models of test_torch_poseidon.

import ctypes  # noqa: E402
import struct  # noqa: E402

import torch  # noqa: E402

from plonky2_tpu_torch import backend  # noqa: E402
from plonky2_tpu_torch.field import extension as ext  # noqa: E402
from tests.test_torch_poseidon import (  # noqa: E402
    _add_lazy, _mac, _mul, _reduce160, _reduce_lh, _sub_lazy,
)

U64 = (1 << 64) - 1
# canonical and not: p, p + 1 and 2^64 - 1 come out of no op, but the plain
# version reduces them, and so must the kernel
RAW_EDGES = EDGES + [P, P + 1, U64, 2**63, 2**64 - 2**32]


def _raw(*shape, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    pick = rng.random(shape) < 0.4
    x[pick] = np.asarray(RAW_EDGES, dtype=np.uint64)[
        rng.integers(0, len(RAW_EDGES), size=int(pick.sum()))]
    return torch.from_numpy(x.view(np.int64))


def _words(plan: bytes) -> list:
    return list(struct.unpack(f"{len(plan) // 8}q", plan))


def _gathered(plan, n_ops):
    """What the kernel reads through a plan: each operand's element at every
    output index (np.uint64 [n]), its index split into the plan's dims."""
    w = _words(plan)
    n, nd, shape = w[0], w[1], w[2:2 + gl.MAX_DIMS]
    idx = np.arange(n, dtype=np.int64)
    digits = []
    for d in range(nd - 1, -1, -1):
        digits.append((d, idx % shape[d]))
        idx = idx // shape[d]
    out = []
    for k in range(n_ops):
        o = w[2 + gl.MAX_DIMS + k * (2 + gl.MAX_DIMS):]
        ptr, value, strides = o[0], o[1] & U64, o[2:2 + gl.MAX_DIMS]
        if not ptr:
            out.append(np.full(n, value, dtype=np.uint64))
            continue
        off = sum(r * strides[d] for d, r in digits)
        mem = np.ctypeslib.as_array(
            (ctypes.c_uint64 * (int(off.max()) + 1)).from_address(ptr))
        out.append(mem[off].copy())
    return out


def _store(ptr, values):
    np.ctypeslib.as_array((ctypes.c_uint64 * len(values)).from_address(
        ptr))[:] = values


def _emulated_call(entry, t, op, *args):
    """The C entries on CPU memory: read the plan as the kernel does, then
    compute with the plain version."""
    t_ = lambda v: torch.from_numpy(v.view(np.int64))
    if entry == "field_binary":
        out, words, _ = args
        a, b = _gathered(words, 2)
        name = {v: k for k, v in gl.BINARY_OPS.items()}[op]
        if name == "exp":
            r = gl.exp_plain(t_(a), int(b[0]))
        elif name == "reduce_lh":
            r = gl._reduce_lh(t_(a), t_(b))
        else:
            r = getattr(gl, name + "_plain")(t_(a), t_(b))
        _store(out, r.numpy().view(np.uint64))
        return 0
    out0, out1, words, _ = args
    a0, a1, b0, b1 = map(t_, _gathered(words, 4))
    name = {v: k for k, v in gl.EXT_OPS.items()}[op]
    r = getattr(ext, name + "_plain")(ext.GF2(a0, a1), ext.GF2(b0, b1))
    _store(out0, r.c0.numpy().view(np.uint64))
    _store(out1, r.c1.numpy().view(np.uint64))
    return 0


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take the kernel path, the C entries emulated."""
    monkeypatch.setattr(backend, "plain_path", lambda t, name: False)
    monkeypatch.setattr(backend, "call", _emulated_call)
    monkeypatch.setattr(backend, "stream", lambda t: 0)
    backend.reset_counts()
    yield
    backend.reset_counts()


def test_cpu_tensors_never_load_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(backend, "lib", refuse)
    monkeypatch.setattr(backend, "_LIB", None)
    a, b = TA[:40], TB[:40]
    for fn in (lambda: gl.add(a, b), lambda: gl.sub(a, b),
               lambda: gl.mul(a, b), lambda: gl.neg(a),
               lambda: gl.mul_small(a, 5), lambda: gl.mul_const(a, P - 2),
               lambda: gl.add_const(a, 3), lambda: gl.inverse(a),
               lambda: gl.reduce_sum(a), lambda: gl.prefix_sum(a),
               lambda: gl.add(gl.const(3, "cpu"), a),
               lambda: GF2(a, b) * GF2(b, a), lambda: GF2(a, b) + GF2(b, a),
               lambda: GF2(a, b) - GF2(b, a)):
        fn()
    x = torch.zeros(3, dtype=torch.int64, device="meta")
    for fn in (lambda: gl.add(x, x), lambda: gl.mul(x, TA[:3]),
               lambda: gl.inverse(x), lambda: GF2(x, x) * GF2(x, x)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn()


def _views():
    """(a, b) operand pairs: broadcast, 0-d, transposed and sliced views,
    a python int and a dim of size 0."""
    x = _raw(6, 5, 4)
    y = _raw(4, 6, seed=6)
    return [
        (x, x),
        (x, y.t()[:, None, :4]),                     # [6, 1, 4] transposed
        (_raw(80, 1, 8), _raw(1, 4, 1, seed=7)),     # the partial products
        (_raw(9, 16), _raw(9, 1, seed=8)),           # [num, N] x [num, 1]
        (x[:, 1:, ::2], x[0, 0, 1]),                 # sliced; 0-d
        (torch.tensor(5), x.permute(2, 0, 1)),
        (x[..., 1], 12345),
        (P + 1, x[1:3].transpose(0, 1)),
        (_raw(2, 1, 3, 1, 2, 1, 2, 3)[:, :, ::2], _raw(2, 1, 2, 1, 1, 1, 3)),
        (_raw(3, 0, 2), _raw(1, 2)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_plan_reads_each_operand_as_broadcast(case):
    a, b = _views()[case]
    device, shape, plan = gl.plan("mul", (a, b))
    words = _words(plan)
    tensors = [x for x in (a, b) if isinstance(x, torch.Tensor)]
    assert device.type == "cpu"
    assert shape == torch.broadcast_shapes(*(x.shape for x in tensors))
    assert 1 <= words[1] <= gl.MAX_DIMS and words[0] == shape.numel()
    if not shape.numel():
        return
    for x, got in zip((a, b), _gathered(plan, 2)):
        want = (torch.full(shape, gl._signed(x & U64)) if isinstance(x, int)
                else x.expand(shape))
        assert (got == want.reshape(-1).numpy().view(np.uint64)).all()


def test_plan_merges_contiguous_dims_and_refuses_the_rest():
    words = lambda a, b: _words(gl.plan("add", (a, b))[2])
    assert words(_raw(4, 5, 6), _raw(4, 5, 6))[:3] == [120, 1, 120]
    x = _raw(4, 5, 6)
    assert words(x[:, 1:], 7)[:4] == [96, 2, 4, 24]
    assert words(x, _raw(6))[:5] == [120, 2, 20, 6, 1]     # [4 5, 6] x [6]
    assert words(x, _raw(5, 1))[:5] == [120, 3, 4, 5, 6]
    with pytest.raises(ValueError, match="do not broadcast"):
        gl.plan("add", (x, _raw(5)))
    with pytest.raises(ValueError, match="above 6"):
        gl.plan("add", (_raw(*[2, 1] * 7)[..., 0], _raw(*[1, 2] * 7)[..., 0]))
    with pytest.raises(ValueError, match="int64"):
        gl.plan("add", (_raw(3), torch.ones(3, dtype=torch.int32)))
    with pytest.raises(ValueError, match="beside"):
        gl.plan("add", (_raw(3), torch.ones(3, dtype=torch.int64,
                                            device="meta")))


def test_wrappers_through_the_emulated_kernel(emulated):
    """Every op on the kernel path (the C entries emulated on CPU memory)
    equals the plain version bit for bit, on non-canonical operands and
    views, one launch an op."""
    for a, b in _views()[:9]:
        for name in ("add", "sub", "mul"):
            want = getattr(gl, name + "_plain")(a, b) if isinstance(
                a, torch.Tensor) else getattr(gl, name + "_plain")(
                    torch.tensor(gl._signed(a)), b)
            assert torch.equal(getattr(gl, name)(a, b), want)
    x = _raw(7, 9)
    checks = [(gl.neg(x), gl.neg_plain(x)),
              (gl.mul_small(x, 41), gl.mul_small_plain(x, 41)),
              (gl.mul_const(x, P - 3), gl.mul_const_plain(x, P - 3)),
              (gl.add_const(x, 2**40), gl.add_const_plain(x, 2**40)),
              (gl.exp(x, 0), gl.exp_plain(x, 0)),
              (gl.exp(x, 2**64 - 1), gl.exp_plain(x, 2**64 - 1)),
              (gl.inverse(x[:, :3]), gl.exp_plain(x[:, :3], P - 2)),
              (gl.reduce_sum(x, 1), gl._reduce_lh(*(
                  h.sum(1) for h in gl._split(x)))),
              (gl.prefix_sum(x), gl._reduce_lh(*(
                  h.cumsum(-1) for h in gl._split(x))))]
    for got, want in checks:
        assert torch.equal(got, want)
    # one launch an op: 9 views x 3 ops, and the 9 checks
    assert backend.KERNELS["field"].launches == 27 + 9
    a = GF2(_raw(5, 3), _raw(5, 3, seed=9))
    b = GF2(_raw(3, seed=10), _raw(3, seed=11))
    for name in ("add", "sub", "mul"):
        got = getattr(GF2, f"__{name}__")(a, b[None])
        want = getattr(ext, name + "_plain")(a, b)
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    assert backend.KERNELS["field_ext"].launches == 3
    assert set(backend.KERNELS["field_ext"].shapes) == {
        ("add", (5, 3)), ("sub", (5, 3)), ("mul", (5, 3))}
    with pytest.raises(ValueError, match="limbs of shapes"):
        GF2(x, x[0]) * GF2(x, x)
    with pytest.raises(ValueError, match="exponent"):
        gl.exp(x, 1 << 64)


# python-int models of the kernels' arithmetic (csrc/field.cu) on the
# carry-chain models of goldilocks_lazy.cuh
def _canonical(x):
    assert x < 1 << 64
    return x - P if x >= P else x


def _exp_model(a, e):
    r = 1
    while e:
        if e & 1:
            r = _mul(r, a)
        e >>= 1
        if e:
            a = _mul(a, a)
    return _canonical(r)


def _ext_mul_model(a0, a1, b0, b1):
    acc = _mac(_mac([0] * 5, a0, b0), _mul(a1, b1), 7)
    acc1 = _mac(_mac([0] * 5, a0, b1), a1, b0)
    return _canonical(_reduce160(acc)), _canonical(_reduce160(acc1))


def test_model_binary_ops_equal_the_plain_version():
    """`field_binary`'s add, sub, mul and reduce_lh on any 64-bit operands
    give the plain version's bits."""
    ops = RAW_EDGES + [int(v) for v in _raw(12).numpy().view(np.uint64)]
    a = torch.tensor([gl._signed(x) for x in ops for _ in ops])
    b = torch.tensor([gl._signed(y) for _ in ops for y in ops])
    pairs = [(x, y) for x in ops for y in ops]
    for name, model in (("add", _add_lazy), ("sub", _sub_lazy),
                        ("mul", _mul)):
        want = getattr(gl, name + "_plain")(a, b).numpy().view(np.uint64)
        got = [_canonical(model(x, y)) for x, y in pairs]
        assert got == [int(v) for v in want], name
    sums = [0, 1, M32, 1 << 32, (1 << 41) - 1, (1 << 62) - 1, 1 << 61]
    L = torch.tensor([x for x in sums for _ in sums])
    H = torch.tensor([y for _ in sums for y in sums])
    want = gl._reduce_lh(L, H).numpy().view(np.uint64)
    assert [_canonical(_reduce_lh(x, y)) for x in sums for y in sums] == \
        [int(v) for v in want]


M32 = (1 << 32) - 1


def test_model_exp_and_inverse():
    ops = RAW_EDGES + [int(v) for v in _raw(6).numpy().view(np.uint64)]
    for e in (0, 1, 2, 7, P - 2, P - 1, U64, 2**63 + 5):
        for a in ops:
            assert _exp_model(a, e) == pow(a, e, P), (a, e)
    assert _exp_model(0, 0) == 1 and _exp_model(P, P - 2) == 0
    x = torch.tensor([gl._signed(v) for v in ops])
    assert [_exp_model(v, P - 2) for v in ops] == \
        gl.to_ints(gl.inverse(x))


def test_model_ext_mul():
    ops = RAW_EDGES + [int(v) for v in _raw(4).numpy().view(np.uint64)]
    quads = [(ops[i], ops[(i * 3 + 1) % len(ops)], ops[(i * 5 + 2) % len(
        ops)], ops[(i * 7 + 3) % len(ops)]) for i in range(len(ops))]
    quads += [(U64, U64, U64, U64), (P, P - 1, U64, 2**63)]
    for a0, a1, b0, b1 in quads:
        want = ((a0 * b0 + 7 * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)
        assert _ext_mul_model(a0, a1, b0, b1) == want
    t = lambda i: torch.tensor([gl._signed(q[i]) for q in quads])
    plain = ext.mul_plain(GF2(t(0), t(1)), GF2(t(2), t(3)))
    assert [_ext_mul_model(*q) for q in quads] == plain.to_pairs()
