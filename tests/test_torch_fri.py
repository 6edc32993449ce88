"""The port's commitment and FRI pieces against the JAX package on seeded
inputs: PolynomialBatch commits (caps, leaves, LDE rows), the polynomial
ops of the opening path, the fold layer, the leaf flattening, and the PoW
wave's smallest-witness rule. Tolerance: exact."""

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.fri import prover as jfri
from plonky2_tpu.fri.oracle import PolynomialBatch as JPolynomialBatch
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.ops import ntt as jntt
from plonky2_tpu.ops import polynomial as jpoly
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.fri import prover as fri
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.hash.hashers import POSEIDON
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.ops import polynomial as poly

RNG = np.random.default_rng(13)
Z = (int(RNG.integers(0, ref.ORDER, dtype=np.uint64)),
     int(RNG.integers(0, ref.ORDER, dtype=np.uint64)))


def _rand(*shape):
    return RNG.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


def _ext(n):
    a, b = _rand(n), _rand(n)
    return GF2(gl.from_u64(a, "cpu"), gl.from_u64(b, "cpu")), \
        JGF2(GF.from_u64(a), GF.from_u64(b))


def _pairs(j):
    c0, c1 = j.to_u64_pair()
    return [(int(x), int(y)) for x, y in zip(np.ravel(c0), np.ravel(c1))]


@pytest.mark.parametrize("num,lg_n", [(3, 3), (20, 5), (135, 4)])
def test_commit_vs_jax(num, lg_n):
    values = _rand(num, 1 << lg_n)
    cap_height = min(4, lg_n + 3)
    ours = PolynomialBatch.from_values(gl.from_u64(values, "cpu"), 3,
                                       cap_height, POSEIDON)
    theirs = JPolynomialBatch.from_values(GF.from_u64(values), 3, False,
                                          cap_height)
    np.testing.assert_array_equal(gl.to_u64(ours.polynomials),
                                  theirs.polynomials.to_u64())
    assert ours.merkle_tree.cap_digests() == \
        [tuple(int(x) for x in d) for d in theirs.merkle_tree.cap_digests()]
    np.testing.assert_array_equal(ours.merkle_tree.leaves_host(),
                                  theirs.merkle_tree.leaves_host())
    idx = [0, 5, (8 << lg_n) - 1]
    np.testing.assert_array_equal(ours.get_lde_values(idx[1], 2),
                                  theirs.get_lde_values(idx[1], 2))
    np.testing.assert_array_equal(ours.get_lde_values_batch(idx),
                                  theirs.get_lde_values_batch(idx))


def test_reduce_polys_and_divide_by_linear():
    polys = _rand(7, 64)
    got = poly.reduce_polys_base(gl.from_u64(polys, "cpu"), Z)
    want = jpoly.reduce_polys_base(GF.from_u64(polys), JGF2.const(*Z))
    assert got.to_pairs() == _pairs(want)
    q = poly.divide_by_linear(got, Z)
    assert q.to_pairs() == _pairs(jpoly.divide_by_linear(want,
                                                         JGF2.const(*Z)))


def test_horner_fold_and_eval():
    ours, theirs = _ext(256)
    got = poly.horner_fold(ours, Z, 4)
    assert got.to_pairs() == _pairs(jpoly.horner_fold(theirs, JGF2.const(*Z),
                                                      4))
    assert poly.eval_poly_ext(ours, Z).reshape(1).to_pairs() == \
        _pairs(jpoly.eval_poly_ext(theirs, JGF2.const(*Z)))


def _horner(row, z) -> tuple:
    """sum_i row[i] z^i at the extension point z, by Horner on the host."""
    acc = (0, 0)
    for c in reversed(row):
        acc = ref.ext2_add(ref.ext2_mul(acc, z), (int(c), 0))
    return acc


@pytest.mark.parametrize("rows_per_point", [False, True])
@pytest.mark.parametrize("chunk", [None, 1, 96])
def test_eval_at_points_vs_host_horner(monkeypatch, rows_per_point, chunk):
    """The openings' evaluator against Horner at each of B points: rows
    [num, n] shared by the points or [num, B, n] a row a point; EVAL_CHUNK
    forced below the input takes the rows one (chunk 1) or two (chunk 96 =
    2 n B, the last block ragged) at a time."""
    num, B, n = 5, 3, 16
    if chunk is not None:
        monkeypatch.setattr(poly, "EVAL_CHUNK", chunk)
    zs = [tuple(int(v) for v in _rand(2)) for _ in range(B)]
    coeffs = _rand(num, B, n) if rows_per_point else _rand(num, n)
    got = poly.eval_at_points(gl.from_u64(coeffs, "cpu"), zs)
    assert got == [
        [_horner(coeffs[r, b] if rows_per_point else coeffs[r], z)
         for r in range(num)] for b, z in enumerate(zs)]


@pytest.mark.parametrize("qdb", range(4))
def test_quotient_coset_vs_host_formulas(qdb):
    """The quotient coset of a degree-2^4 quotient, 2^qdb points a row, on
    the host: x_i = g w^i, 1 / (x^n - 1), and the Lagrange selectors
    a (x^n - 1) / (n (x - a)) of the first point a = 1 and the last
    a = g_H^(n-1)."""
    degree_bits = 4
    n = 1 << degree_bits
    last = ref.inverse(ref.primitive_root_of_unity(degree_bits))
    x, zh_inv, sel = poly.quotient_coset(degree_bits, qdb, (1, last), "cpu")
    w = ref.primitive_root_of_unity(degree_bits + qdb)
    xs = [ref.mul(ref.MULTIPLICATIVE_GROUP_GENERATOR, ref.exp(w, i))
          for i in range(n << qdb)]
    zh = [ref.sub(ref.exp(v, n), 1) for v in xs]

    def lagrange(a):
        return [ref.mul(ref.mul(a, z), ref.inverse(ref.mul(n, ref.sub(v, a))))
                for v, z in zip(xs, zh)]

    assert gl.to_ints(x) == xs
    assert gl.to_ints(zh_inv) == [ref.inverse(z) for z in zh]
    assert gl.to_ints(sel[0]) == lagrange(1)
    assert gl.to_ints(sel[1]) == lagrange(last)


def test_fold_layer_and_leaves_vs_jax():
    ours, theirs = _ext(1 << 8)
    shift = ref.exp(ref.MULTIPLICATIVE_GROUP_GENERATOR, 16)
    folded = poly.horner_fold(ours, Z, 4)
    values = ntt.coset_fft_ext(folded, shift)
    jfolded = jpoly.horner_fold(theirs, JGF2.const(*Z), 4)
    jvalues = jntt.coset_fft_ext(jfolded, shift)
    assert folded.to_pairs() == _pairs(jfolded)
    assert values.to_pairs() == _pairs(jvalues)
    np.testing.assert_array_equal(
        gl.to_u64(fri._brv_leaves(ours, 16)),
        jfri._brv_leaves_fn(1 << 8, 16)(theirs).to_u64())


def test_pow_wave_takes_smallest_witness():
    """The wave (K2's plain version on CPU) and the JAX grind find the same
    witness for the same transcript state; 6 bits, waves of 64."""
    ours, theirs = Challenger(POSEIDON), JChallenger()
    for x in _rand(11):
        ours.observe_element(int(x))
        theirs.observe_element(int(x))
    state = list(ours.sponge_state)
    for i, x in enumerate(ours.input_buffer):
        state[i] = x
    got = fri._pow_wave(POSEIDON.permute, state, len(ours.input_buffer),
                        6, 64, "cpu")
    assert got == jfri.fri_proof_of_work(theirs, 6, batch=64)
    assert got == fri._pow_grind_host(POSEIDON.permute_many_host, state,
                                      len(ours.input_buffer), 6, 64)


def test_poseidon2_pow_wave_and_host_grind_take_smallest_witness():
    """Under Poseidon2 the wave (K6's plain version on CPU) and the host C
    grind find the first witness the python oracle accepts; 6 bits."""
    from plonky2_tpu_torch.hash import poseidon2 as ps2
    from plonky2_tpu_torch.hash.hashers import POSEIDON2
    state = [int(x) for x in _rand(12)]
    pos, threshold = 3, 1 << (64 - 6)
    want = next(w for w in range(1 << 12)
                if ps2.poseidon2_oracle(state[:pos] + [w] + state[pos + 1:])[7]
                < threshold)
    assert fri._pow_wave(POSEIDON2.permute, state, pos, 6, 64,
                         "cpu") == want
    assert fri._pow_grind_host(POSEIDON2.permute_many_host, state, pos,
                               6, 64) == want
