"""The port's Poseidon (kernels K2/K3 through their plain versions on CPU)
and Merkle tree against the JAX package: the permutation against the host
oracle and the reference KATs, the leaf sponge against the JAX device
sponge, caps and proofs against the JAX MerkleTree (the tree's plain path,
which fills the tree kernel's buffer at its offsets). Tolerance: exact.

The CUDA kernels run only on the card, so their arithmetic is also held
here through a python-int model of each step of `csrc/poseidon.cu`: the
32-bit carry chains of the multiply and the reductions, with the carry flag
and u32/u64 wraparound as PTX has them, against exact arithmetic on edge
operands; and the kernel's permutation schedule run on that model with the
constant tables parsed from the generated `poseidon_tables.h`, against the
JAX oracle.

The JAX sponge runs as the JAX package's own CPU tests run it
(tests/test_poseidon.py): `hash_no_pad` on [B, L] rows, the same sponge as
`hash_no_pad_lanes` in the other layout. The lanes form itself is not run:
on XLA:CPU it takes tens of minutes, which is why tests/test_pallas_poseidon
skips on CPU."""

import os
import re

import numpy as np
import pytest
import torch

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.hash import poseidon as jps
from plonky2_tpu.hash import poseidon_constants as jpc
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.hash import poseidon as ps
from plonky2_tpu_torch.hash.hashers import POSEIDON
from plonky2_tpu_torch.hash.merkle import (
    MerkleTree, verify_merkle_proof_oracle,
)
from plonky2_tpu_torch.hash.sponge import tree_offsets
from tests.test_poseidon import KATS

RNG = np.random.default_rng(9)


def _rand(*shape):
    return RNG.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


def test_permute_kats():
    states = gl.from_u64(np.asarray([k[0] for k in KATS], dtype=np.uint64),
                         "cpu")
    want = np.asarray([k[1] for k in KATS], dtype=np.uint64)
    np.testing.assert_array_equal(gl.to_u64(ps.permute(states)), want)
    for inp, out in KATS:
        assert ps.permute_host(inp) == out


def test_permute_vs_oracle_random():
    x = _rand(64, 12)
    got = gl.to_u64(ps.permute(gl.from_u64(x, "cpu")))
    want = [jps.poseidon_oracle([int(v) for v in row]) for row in x]
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))


@pytest.mark.parametrize("L", [5, 8, 20, 32, 135])
def test_leaf_sponge_vs_jax(L):
    x = _rand(L, 256)
    got = gl.to_u64(ps.hash_leaves(gl.from_u64(x, "cpu")))       # [256, 4]
    want = jps.hash_no_pad(GF.from_u64(x.T.copy())).to_u64()     # [256, 4]
    np.testing.assert_array_equal(got, want)
    assert list(got[3]) == jps.hash_no_pad_oracle([int(v) for v in x[:, 3]])


def test_host_oracles():
    x = [int(v) for v in _rand(21)]
    assert list(POSEIDON.hash_no_pad_oracle(x)) == jps.hash_no_pad_oracle(x)
    assert list(POSEIDON.hash_or_noop_oracle(x[:3])) == \
        jps.hash_or_noop_oracle(x[:3])
    assert list(POSEIDON.two_to_one_oracle(x[:4], x[4:8])) == \
        jps.compress_oracle(x[:4], x[4:8])
    left, right = _rand(7, 4), _rand(7, 4)
    got = gl.to_u64(ps.compress(gl.from_u64(left, "cpu"),
                                gl.from_u64(right, "cpu")))
    want = [jps.compress_oracle([int(v) for v in a], [int(v) for v in b])
            for a, b in zip(left, right)]
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.uint64))


@pytest.mark.parametrize("lg_n", range(3, 9))
def test_merkle_vs_jax(lg_n):
    cap_height = min(4, lg_n)
    leaves = _rand(1 << lg_n, 135)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON)
    jtree = JMerkleTree(GF.from_u64(leaves), cap_height)
    assert tree.cap_digests() == jtree.cap_digests()
    idx = list(range(1 << lg_n))
    proofs = tree.prove_batch(idx)
    for i in idx:
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    for i in (0, (1 << lg_n) - 1):
        leaf = [int(v) for v in leaves[i]]
        assert verify_merkle_proof_oracle(leaf, i, tree.cap_digests(),
                                          proofs[i], POSEIDON)
        leaf[0] = (leaf[0] + 1) % ref.ORDER
        assert not verify_merkle_proof_oracle(leaf, i, tree.cap_digests(),
                                              proofs[i], POSEIDON)


@pytest.mark.parametrize("swap", [0, 1])
def test_poseidon_gate_trace_python_matches_native(swap):
    """The PoseidonGate witness row without a C compiler equals the host C
    trace the generator uses when one is present."""
    from plonky2_tpu_torch import host
    from plonky2_tpu_torch.gates.poseidon_gate import (
        _TRACE_COLS, _trace_python,
    )
    inputs = [int(v) for v in _rand(12)]
    trace = host.poseidon_generator_trace(inputs, swap)
    if trace is None:
        pytest.skip("no C compiler for the native trace")
    got = _trace_python(inputs, swap)
    assert [got[c] for c in _TRACE_COLS] == [trace[c] for c in _TRACE_COLS]


def test_build_key_follows_sources_tables_and_flags(tmp_path):
    """A kernel or host library is named by a hash of its sources, its
    generated constant headers and its compiler command, so a build left
    from other sources or other constants is never loaded."""
    from plonky2_tpu_torch import backend, host
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    tables = backend._tables()
    key = backend.build_key([str(src)], tables, ["-O3"])
    assert key == backend.build_key([str(src)], backend._tables(), ["-O3"])
    src.write_text("// v2\n")
    assert backend.build_key([str(src)], tables, ["-O3"]) != key
    src.write_text("// v1\n")
    edited = dict(tables)
    edited["poseidon2_tables.h"] += "// one more line\n"
    assert backend.build_key([str(src)], edited, ["-O3"]) != key
    assert backend.build_key([str(src)], tables, ["-O2"]) != key
    lib = host.load()
    if lib is not None:
        name = os.path.basename(lib._name)
        assert name.startswith("libplonky2_host-") and len(name) == 35


@pytest.mark.parametrize("lg_n,cap_height", [(lg, cap) for lg in range(11)
                                             for cap in range(min(lg, 4) + 1)])
def test_tree_plain_path_vs_jax(lg_n, cap_height):
    """Caps and every proof of the tree built through `merkle_layers` (the
    plain path of the tree kernel on CPU) against the JAX MerkleTree, and
    its layers as views into one buffer at the kernel's offsets."""
    leaves = _rand(1 << lg_n, 7)
    tree = MerkleTree(gl.from_u64(leaves, "cpu"), cap_height, POSEIDON)
    jtree = JMerkleTree(GF.from_u64(leaves), cap_height)
    assert tree.cap_digests() == jtree.cap_digests()
    proofs = tree.prove_batch(list(range(1 << lg_n)))
    for i in range(1 << lg_n):
        np.testing.assert_array_equal(proofs[i], jtree.prove(i))
    offs = tree_offsets(1 << lg_n, cap_height)
    above = tree.layers[1:]
    assert len(above) == lg_n - cap_height == len(offs) - 1
    if above:
        base = above[0].data_ptr()
        storage = above[0].untyped_storage().data_ptr()
        for layer, lo, hi in zip(above, offs, offs[1:]):
            assert layer.shape == (hi - lo, 4)
            assert layer.untyped_storage().data_ptr() == storage
            assert layer.data_ptr() == base + 32 * lo
        assert offs[-1] == (1 << lg_n) - (1 << cap_height)


@pytest.mark.parametrize("hasher", ["poseidon", "poseidon2"])
@pytest.mark.parametrize("shape,cap_height", [((8, 3), 1), ((8, 4), 4),
                                              ((6, 4), 1), ((8, 4), -1)])
def test_tree_wrapper_rejects_bad_input(shape, cap_height, hasher):
    """Digests that are not [2^k, 4], or a cap above the root, raise before
    any launch, through the tree entry of either hasher."""
    from plonky2_tpu_torch.hash.hashers import POSEIDON2
    d = torch.zeros(shape, dtype=torch.int64)
    merkle_layers = {"poseidon": ps.merkle_layers,
                     "poseidon2": POSEIDON2.merkle_layers}[hasher]
    with pytest.raises((ValueError, AssertionError)):
        merkle_layers(d, cap_height)


# ---------------------------------------------------------------------------
# The generated constant tables of csrc/poseidon.cu
# ---------------------------------------------------------------------------

def _kernel_tables(header: str = "poseidon_tables.h") -> dict:
    """{name: [int]} parsed from a generated constant header."""
    from plonky2_tpu_torch import backend
    text = backend._tables()[header]
    tables = {}
    for m in re.finditer(r"__constant__ (uint64_t|uint32_t) (\w+)\[(\d+)\]"
                         r" = \{([^}]*)\};", text):
        vals = [int(v.rstrip("UL"), 16) for v in m.group(4).split(",")]
        assert len(vals) == int(m.group(3))
        tables[m.group(2)] = vals
    return tables


def test_kernel_tables_match_the_jax_constants():
    t = _kernel_tables()
    w = jpc.SPONGE_WIDTH
    assert t["C_RC"] == list(jpc.ALL_ROUND_CONSTANTS) + [0] * w
    assert len(t["C_RC"]) == (jpc.N_ROUNDS + 1) * w
    mds = [[jpc.MDS_MATRIX_CIRC[(c - r) % w]
            + (jpc.MDS_MATRIX_DIAG[r] if c == r else 0) for c in range(w)]
           for r in range(w)]
    assert t["C_MDS"] == [x for row in mds for x in row]
    assert max(t["C_MDS"]) < 1 << 6 and \
        max(sum(t["C_MDS"][r * w:(r + 1) * w]) for r in range(w)) < 1 << 9
    # the MDS rows are the JAX oracle's
    v = [int(x) for x in _rand(w)]
    assert [sum(m * x for m, x in zip(row, v)) % ref.ORDER for row in mds] \
        == jps._mds_oracle(v)


# ---------------------------------------------------------------------------
# A python-int model of the kernel's arithmetic (PTX carry flag, u32 limbs)
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1
P = ref.ORDER


class _Carry:
    """The PTX carry flag CC.CF and the u32 instructions of the asm blocks;
    `last=True` asserts that an instruction the kernel ends a chain with
    produces no carry or borrow out."""

    def __init__(self):
        self.cf = 0

    def add_cc(self, a, b):
        t = a + b
        self.cf = t >> 32
        return t & M32

    def addc(self, a, b, cc=False, last=False):
        t = a + b + self.cf
        if cc or last:
            self.cf = t >> 32
        assert not (last and self.cf), "carry out of a chain's end"
        return t & M32

    def sub_cc(self, a, b):
        t = a - b
        self.cf = int(t < 0)
        return t & M32

    def subc(self, a, b, cc=False, last=False):
        t = a - b - self.cf
        if cc or last:
            self.cf = int(t < 0)
        assert not (last and self.cf), "borrow out of a chain's end"
        return t & M32

    def mad_lo_cc(self, a, b, c):
        return self.add_cc((a * b) & M32, c)

    def madc_hi(self, a, b, c, cc=False, last=False):
        return self.addc((a * b) >> 32, c, cc, last)


def _mul_wide(a, b):
    k = _Carry()
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    r0 = (a0 * b0) & M32
    r1 = (a0 * b0) >> 32
    r1 = k.mad_lo_cc(a0, b1, r1)
    r2 = k.madc_hi(a0, b1, 0, last=True)
    r1 = k.mad_lo_cc(a1, b0, r1)
    r2 = k.madc_hi(a1, b0, r2, cc=True)
    r3 = k.madc_hi(a1, b1, 0, last=True)
    r2 = k.mad_lo_cc(a1, b1, r2)
    r3 = k.addc(r3, 0, last=True)
    return r0, r1, r2, r3


def _reduce128(r0, r1, r2, r3):
    k = _Carry()
    t0 = k.sub_cc(r0, r3)
    t1 = k.subc(r1, 0, cc=True)
    m = k.subc(0, 0)
    t0 = k.sub_cc(t0, m)
    t1 = k.subc(t1, 0, last=True)
    w0 = k.sub_cc(0, r2)
    w1 = k.subc(r2, 0, last=True)
    t0 = k.add_cc(t0, w0)
    t1 = k.addc(t1, w1, cc=True)
    m = (-k.addc(0, 0)) & M32
    t0 = k.add_cc(t0, m)
    t1 = k.addc(t1, 0, last=True)
    return t0 | t1 << 32


def _mul(a, b):
    return _reduce128(*_mul_wide(a, b))


def _reduce_lh(lo_sum, hi_sum):
    k = _Carry()
    l0, l1, h0, h1 = lo_sum & M32, lo_sum >> 32, hi_sum & M32, hi_sum >> 32
    z1 = k.add_cc(l1, h0)
    h1 = k.addc(h1, 0, last=True)
    w0 = k.sub_cc(0, h1)
    w1 = k.subc(h1, 0, last=True)
    r0 = k.add_cc(l0, w0)
    r1 = k.addc(z1, w1, cc=True)
    c = (-k.addc(0, 0)) & M32
    r0 = k.add_cc(r0, c)
    r1 = k.addc(r1, 0, last=True)
    return r0 | r1 << 32


def _add_canon(a, c):
    assert c < P
    k = _Carry()
    r0 = k.add_cc(a & M32, c & M32)
    r1 = k.addc(a >> 32, c >> 32, cc=True)
    m = (-k.addc(0, 0)) & M32
    r0 = k.add_cc(r0, m)
    r1 = k.addc(r1, 0, last=True)
    return r0 | r1 << 32


def _add_lazy(a, b):
    """`add_lazy`, the NTT butterfly's add, for any a, b < 2^64."""
    k = _Carry()
    r0 = k.add_cc(a & M32, b & M32)
    r1 = k.addc(a >> 32, b >> 32, cc=True)
    m = (-k.addc(0, 0)) & M32
    r0 = k.add_cc(r0, m)
    r1 = k.addc(r1, 0, cc=True)
    m = (-k.addc(0, 0)) & M32
    r0 = k.add_cc(r0, m)
    r1 = k.addc(r1, 0, last=True)
    return r0 | r1 << 32


def _sub_lazy(a, b):
    """`sub_lazy`, the NTT butterfly's subtract, for any a, b < 2^64."""
    k = _Carry()
    r0 = k.sub_cc(a & M32, b & M32)
    r1 = k.subc(a >> 32, b >> 32, cc=True)
    m = k.subc(0, 0)
    r0 = k.sub_cc(r0, m)
    r1 = k.subc(r1, 0, cc=True)
    m = k.subc(0, 0)
    r0 = k.sub_cc(r0, m)
    r1 = k.subc(r1, 0, last=True)
    return r0 | r1 << 32


def _mad_wide(a, b, c):
    d = a * b + c
    assert d < 1 << 64, "mad.wide.u32 accumulator overflow"
    return d


def _mds_add(s, rc, mds):
    lo = [x & M32 for x in s]
    hi = [x >> 32 for x in s]
    out = []
    for r in range(12):
        acc_lo, acc_hi = rc[r] & M32, rc[r] >> 32
        for c in range(12):
            acc_lo = _mad_wide(lo[c], mds[r * 12 + c], acc_lo)
            acc_hi = _mad_wide(hi[c], mds[r * 12 + c], acc_hi)
        out.append(_reduce_lh(acc_lo, acc_hi))
    return out


def _mac(acc, a, b):
    """acc (five u32 limbs) += a b, as `mac`."""
    p = _mul_wide(a, b)
    k = _Carry()
    out = [k.add_cc(acc[0], p[0])]
    for i in (1, 2, 3):
        out.append(k.addc(acc[i], p[i], cc=True))
    out.append(k.addc(acc[4], 0, last=True))
    return out


def _reduce160(acc):
    x = _reduce128(*acc[:4])
    k = _Carry()
    t0, t1 = x & M32, x >> 32
    t1 = k.sub_cc(t1, acc[4])
    m = k.subc(0, 0)
    t0 = k.sub_cc(t0, m)
    t1 = k.subc(t1, 0, last=True)
    return t0 | t1 << 32


def _mul_add(a, b, c):
    p = _mul_wide(a, b)
    k = _Carry()
    r0 = k.add_cc(p[0], c & M32)
    r1 = k.addc(p[1], c >> 32, cc=True)
    r2 = k.addc(p[2], 0, cc=True)
    r3 = k.addc(p[3], 0, last=True)
    return _reduce128(r0, r1, r2, r3)


def _sbox(x):
    x2 = _mul(x, x)
    x3 = _mul(x2, x)
    x4 = _mul(x2, x2)
    return _mul(x4, x3)


def _permute_model(state, tables):
    """The kernel's `permute_lanes` (the plain schedule, one MDS row per
    lane) on the model arithmetic: values anywhere in [0, 2^64) between
    operations, canonical on the way out."""
    rc, mds = tables["C_RC"], tables["C_MDS"]
    s = [_add_canon(x, rc[i]) for i, x in enumerate(state)]
    for r in range(30):
        if r < 4 or r >= 26:
            s = [_sbox(x) for x in s]
        else:
            s[0] = _sbox(s[0])
        s = _mds_add(s, rc[12 * (r + 1):12 * (r + 2)], mds)
    return [x - P if x >= P else x for x in s]


def _permute_fast_model(state, t):
    """The kernel's `permute` (fast-partial-round form) on the model
    arithmetic."""
    rc, full_rc = t["C_RC"], t["C_FULL_RC"]
    s = [_add_canon(x, rc[i]) for i, x in enumerate(state)]
    for r in range(8):
        s = _mds_add([_sbox(x) for x in s], full_rc[12 * r:12 * (r + 1)],
                     t["C_MDS"])
        if r != 3:
            continue
        init = t["C_INIT_MAT"]
        rest = []
        for c in range(11):
            acc = [0] * 5
            for k in range(11):
                acc = _mac(acc, s[k + 1], init[k * 11 + c])
            rest.append(_reduce160(acc))
        s = [s[0]] + rest
        for k in range(22):
            s0 = _add_canon(_sbox(s[0]), t["C_PARTIAL_RC"][k])
            acc = _mac([0] * 5, s0, t["C_MDS"][0])
            for i in range(1, 12):
                acc = _mac(acc, s[i], t["C_W_HATS"][k * 11 + i - 1])
                s[i] = _mul_add(s0, t["C_VS"][k * 11 + i - 1], s[i])
            s[0] = _reduce160(acc)
        s = [_add_canon(x, rc[12 * 26 + i]) for i, x in enumerate(s)]
    return [x - P if x >= P else x for x in s]


EDGE = [0, 1, 2, P - 1, P, P + 1, M32, 1 << 32, (1 << 32) + 1, 1 << 63,
        (1 << 64) - (1 << 32), (1 << 64) - 1, (1 << 64) - 2]


def test_model_mul_on_edge_operands():
    rnd = [int(v) for v in RNG.integers(0, 1 << 64, size=24, dtype=np.uint64)]
    for a in EDGE + rnd:
        for b in EDGE + rnd:
            r = _mul(a, b)
            assert r < 1 << 64 and r % P == a * b % P, (a, b)


def test_model_reduce_lh_and_add_on_edge_operands():
    sums = [0, 1, M32, 1 << 32, (1 << 41) - 1, 264 * M32 + M32,
            (1 << 64) - (1 << 33), (1 << 63)]
    for lo in sums:
        for hi in sums:
            if hi >> 32 == M32:
                continue
            r = _reduce_lh(lo, hi)
            assert r < 1 << 64 and r % P == (lo + (hi << 32)) % P, (lo, hi)
    for a in EDGE:
        for c in [0, 1, M32, 1 << 32, P - 2, P - 1]:
            r = _add_canon(a, c)
            assert r < 1 << 64 and r % P == (a + c) % P, (a, c)


@pytest.mark.parametrize("kind", ["edge", "random"])
def test_model_lazy_add_and_sub(kind):
    """The NTT's butterfly add and subtract on canonical and non-canonical
    operands, the cases of a second carry and a second borrow among them."""
    if kind == "edge":
        ops = EDGE + [M32, 1 << 32, P - 1, 0, 1]
    else:
        ops = [int(v) for v in RNG.integers(0, 1 << 64, size=40,
                                            dtype=np.uint64)]
    for a in ops:
        for b in ops:
            for fn, want in ((_add_lazy, a + b), (_sub_lazy, a - b)):
                r = fn(a, b)
                assert r < 1 << 64 and r % P == want % P, (fn, a, b)
    # a + b >= 2^65 - 2^32 + 1 carries twice; a - b in (-2^64, 2^32 - 1 -
    # 2^64) borrows twice
    assert _add_lazy((1 << 64) - 1, (1 << 64) - 1) % P == \
        (2 * ((1 << 64) - 1)) % P
    assert _sub_lazy(0, (1 << 64) - 1) % P == (-((1 << 64) - 1)) % P


def test_model_lazy_ntt_row():
    """A 2^6 radix-2 DIT network on the model's `mul`, `_add_lazy` and
    `_sub_lazy` with values left unreduced, made canonical once at the end,
    on rows of all p - 1, all 2^64 - 1 and edge values mixed with random
    ones: equal to the transform evaluated point by point."""
    lg = 6
    n = 1 << lg
    w = ref.primitive_root_of_unity(lg)
    rev = [int(format(i, f"0{lg}b")[::-1], 2) for i in range(n)]
    rows = [[P - 1] * n, [(1 << 64) - 1] * n,
            [EDGE[i % len(EDGE)] if i % 2 else
             int(RNG.integers(0, 1 << 64, dtype=np.uint64)) for i in range(n)]]
    for row in rows:
        x = [row[rev[k]] for k in range(n)]
        for s in range(lg):
            m = 1 << s
            for k in range(n):
                if k & m:
                    continue
                t = _mul(ref.exp(w, (k % m) << (lg - 1 - s)), x[k + m])
                x[k], x[k + m] = _add_lazy(x[k], t), _sub_lazy(x[k], t)
        got = [v - P if v >= P else v for v in x]
        want = [sum(c * ref.exp(w, i * j) for i, c in enumerate(row)) % P
                for j in range(n)]
        assert got == want


def test_model_mac_reduce160_and_mul_add_on_edge_operands():
    ops = EDGE + [int(v) for v in RNG.integers(0, 1 << 64, size=6,
                                                dtype=np.uint64)]
    for a in ops:
        for c in ops:
            r = _mul_add(a, (1 << 64) - 1, c)
            assert r < 1 << 64 and r % P == (a * ((1 << 64) - 1) + c) % P
    # twelve products of the largest operands: the widest sum `permute`
    # accumulates before reduce160
    acc = [0] * 5
    for a in ops[:12]:
        acc = _mac(acc, a, (1 << 64) - 1)
    exact = sum(a * ((1 << 64) - 1) for a in ops[:12])
    assert sum(x << (32 * i) for i, x in enumerate(acc)) == exact
    r = _reduce160(acc)
    assert r < 1 << 64 and r % P == exact % P


def test_model_mds_on_the_largest_inputs():
    t = _kernel_tables()
    s = [(1 << 64) - 1] * 12
    rc = [P - 1] * 12
    got = _mds_add(s, rc, t["C_MDS"])
    for r in range(12):
        want = (sum(t["C_MDS"][r * 12 + c] * s[c] for c in range(12))
                + rc[r]) % P
        assert got[r] % P == want


@pytest.mark.parametrize("form", ["permute", "permute_lanes"])
@pytest.mark.parametrize("kind", ["random", "edge", "non-canonical"])
def test_model_permutation_vs_oracle(form, kind):
    """The kernel's two schedules (`permute`, the fast-partial-round form
    of one thread; `permute_lanes`, the plain form of a lane group) and
    their tables, on the model arithmetic, against the JAX oracle."""
    t = _kernel_tables()
    rng = np.random.default_rng({"random": 1, "edge": 2,
                                 "non-canonical": 3}[kind])
    for _ in range(3):
        if kind == "random":
            state = [int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)]
        elif kind == "edge":
            state = [EDGE[i] % P for i in rng.integers(0, len(EDGE), 12)]
        else:
            state = [EDGE[i] for i in rng.integers(0, len(EDGE), 12)]
        want = jps.poseidon_oracle([x % P for x in state])
        model = _permute_fast_model if form == "permute" else _permute_model
        assert model(state, t) == list(want)
