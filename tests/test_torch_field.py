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
