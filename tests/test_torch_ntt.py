"""The port's NTT API (plonky2_tpu_torch/ops/ntt.py, kernel K1's plain
version on CPU) against plonky2_tpu.ops.ntt, element-wise over full outputs,
on seeded inputs. Tolerance: exact."""

import numpy as np
import pytest

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.ops import ntt as jntt
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.ops import ntt

RNG = np.random.default_rng(5)


def _rand(*shape):
    return RNG.integers(0, ref.ORDER, size=shape, dtype=np.uint64)


def _jax_pair(g):
    c0, c1 = g.to_u64_pair()
    return np.stack([c0, c1])


@pytest.mark.parametrize("name", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_base_transforms(name):
    x = _rand(2, 64)
    got = gl.to_u64(getattr(ntt, name)(gl.from_u64(x, "cpu")))
    np.testing.assert_array_equal(
        got, getattr(jntt, name)(GF.from_u64(x)).to_u64())


@pytest.mark.parametrize("name", ["fft_ext", "coset_fft_ext"])
def test_ext_transforms(name):
    x0, x1 = _rand(2, 64), _rand(2, 64)
    got = getattr(ntt, name)(GF2(gl.from_u64(x0, "cpu"),
                                 gl.from_u64(x1, "cpu")))
    want = getattr(jntt, name)(JGF2(GF.from_u64(x0), GF.from_u64(x1)))
    np.testing.assert_array_equal(
        np.stack([gl.to_u64(got.c0), gl.to_u64(got.c1)]), _jax_pair(want))


@pytest.mark.parametrize("name", ["lde_fft", "coset_lde"])
@pytest.mark.parametrize("shape", [(16, 8), (8,), (4, 1 << 10)])
def test_lde(name, shape):
    x = _rand(*shape)
    got = gl.to_u64(getattr(ntt, name)(gl.from_u64(x, "cpu"), 3))
    np.testing.assert_array_equal(
        got, getattr(jntt, name)(GF.from_u64(x), 3).to_u64())


@pytest.mark.parametrize("lg_n", range(3, 11))
def test_fri_coset_fft_sizes(lg_n):
    """The FRI fold's coset_fft at shift 7^(16^k), sizes 2^3..2^10."""
    shift = ref.exp(ref.MULTIPLICATIVE_GROUP_GENERATOR, 16 ** (lg_n % 3 + 1))
    x = _rand(1 << lg_n)
    got = gl.to_u64(ntt.coset_fft(gl.from_u64(x, "cpu"), shift))
    np.testing.assert_array_equal(
        got, jntt.coset_fft(GF.from_u64(x), shift).to_u64())


@pytest.mark.parametrize("start", [1, 3])
def test_dit_stage_skip(start):
    """lde_fft's rate-bits skip: on a bit-reversed zero-padded input the
    first `start` stages only spread each entry over its block, so starting
    at `start` from the repeated entries gives the same transform."""
    x = gl.from_u64(_rand(3, 1 << 7), "cpu")
    padded = x.new_zeros((3, x.shape[-1] << start))
    padded[:, ::1 << start] = x
    np.testing.assert_array_equal(
        gl.to_u64(ntt.dit(x.repeat_interleave(1 << start, dim=-1), start)),
        gl.to_u64(ntt.dit(padded, 0)))
