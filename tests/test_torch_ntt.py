"""The port's NTT API (plonky2_tpu_torch/ops/ntt.py, kernel K1's plain
versions on CPU) against plonky2_tpu.ops.ntt, element-wise over full outputs,
on seeded inputs; and a model of K1's schedule (csrc/ntt.cu: the gather,
the stages each pass runs, every butterfly's twiddle index, pass B's
columns, the inverse's table and store scale) on the tables the wrapper
hands the kernel, at reduced tile sizes, against the same reference.
Tolerance: exact."""

import os
import re

import numpy as np
import pytest
import torch

from plonky2_tpu.field import reference as ref
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.goldilocks import GF
from plonky2_tpu.ops import ntt as jntt
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.utils.bits import log2_strict, reverse_bits

RNG = np.random.default_rng(5)
G = ref.MULTIPLICATIVE_GROUP_GENERATOR
# the prover's coset shift and the FRI fold layers' shifts 7^(2^k)
SHIFTS = [G, ref.exp(G, 16), ref.exp(G, 256), ref.exp(G, 8)]
NTT_CU = os.path.join(os.path.dirname(ntt.__file__), "..", "csrc", "ntt.cu")


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
    """The forward entry's rate-bits skip: from the repeated bit-reversed
    entries, starting at stage `start` gives the transform of the input
    zero-padded to 2^start times its length."""
    x = gl.from_u64(_rand(3, 1 << 7), "cpu")
    padded = torch.cat([x, x.new_zeros((3, (x.shape[-1] << start)
                                        - x.shape[-1]))], dim=-1)
    np.testing.assert_array_equal(
        gl.to_u64(ntt.forward_plain(x, start, G)),
        gl.to_u64(ntt.forward_plain(padded, 0, G)))


# --- a model of csrc/ntt.cu's schedule --------------------------------------

def _kernel_constant(name: str) -> int:
    with open(NTT_CU) as f:
        src = f.read()
    m = re.search(r"constexpr int %s = (\w+);" % name, src)
    value = m.group(1)
    if not value.isdigit():     # a macro with a default
        value = re.search(r"#define %s (\d+)" % value, src).group(1)
    return int(value)


def _rev(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> i) & 1) << (bits - 1 - i)
    return out


class _Schedule:
    """csrc/ntt.cu's `transform` at the given sizes (the kernel's own are
    its constants named in KERNEL), on field values of the port's
    canonical arithmetic: which elements each pass and thread reads and
    writes, which stages it runs and which twiddle entry each butterfly
    takes. Records the tiles of pass A and the elements of pass B's
    columns."""

    def __init__(self, row_lg, tile_lg, min_tile_lg, min_blocks,
                 shrink_col_lg, max_col_lg, radix_lg=3, max_lg=24):
        self.row_lg, self.tile_lg, self.min_tile_lg = row_lg, tile_lg, \
            min_tile_lg
        self.min_blocks, self.shrink_col_lg, self.max_col_lg = min_blocks, \
            shrink_col_lg, max_col_lg
        self.radix_lg, self.max_lg = radix_lg, max_lg

    def column_rounds(self, lg_N, T):
        """`transform`'s pass B: [(s0, stages)], one round, or two when
        more than max_col_lg stages lie above the tile."""
        c = lg_N - T
        if c <= self.max_col_lg:
            return [(T, c)]
        c1 = c // 2
        assert 3 <= c1 <= 5, "`first_columns` takes 3 to 5 stages"
        return [(T, c1), (T + c1, c - c1)]

    def pass_a_tile(self, batch, lg_N, rate):
        """`transform`'s tile for a row of 2^lg_N: the largest below the
        row, shrunk while pass A has fewer than min_blocks blocks."""
        lg_T = min(lg_N - 1, self.tile_lg)
        lowest = max(lg_N - self.shrink_col_lg, self.min_tile_lg, rate)
        while lg_T > lowest and batch << (lg_N - lg_T) < self.min_blocks:
            lg_T -= 1
        return lg_T

    def gather(self, row, k0, lg_T):
        """s[k] = x[k0 + k], k < 2^lg_T, as `gather`."""
        lg_n = self.lg_N - self.rate
        e = np.arange(1 << (lg_T - self.rate))
        i = torch.as_tensor(_rev((k0 >> self.rate) + e, lg_n))
        v = self.flat[row * self.in_stride + self.in_offset + i]
        if self.pre is not None:
            v = gl.mul(v, self.pre[i])
        return v.repeat_interleave(1 << self.rate)

    def butterflies(self, v, s0, b, K):
        """`butterflies<K>` on v [threads, 2^K], b [threads]."""
        for u in range(K):
            m = 1 << u
            for q in range(1 << K):
                if q & m:
                    continue
                j = (1 << (s0 + u)) + b + ((q & (m - 1)) << s0)
                assert np.all(j < (2 << (s0 + u))), "twiddle of another stage"
                x = gl.mul(self.tw[torch.as_tensor(j)], v[:, q + m])
                y = v[:, q].clone()
                v[:, q], v[:, q + m] = gl.add(y, x), gl.sub(y, x)
        return v

    def stages_shared(self, s, lg_T, start):
        """`stages_shared`: rounds of up to three stages."""
        st = start
        while st < lg_T:
            rounds = -(-(lg_T - st) // self.radix_lg)
            K = -(-(lg_T - st) // rounds)
            g = np.arange(1 << (lg_T - K))
            b = g & ((1 << st) - 1)
            base = b | ((g >> st) << (st + K))
            idx = torch.as_tensor(base[:, None] + (np.arange(1 << K) << st))
            assert sorted(idx.reshape(-1).tolist()) == list(range(1 << lg_T))
            s[idx] = self.butterflies(s[idx], st, b, K)
            self.stages_run.extend(range(st, st + K))
            st += K
        return s

    def finish(self, v, k):
        return v if self.post is None else gl.mul(v, self.post[k])

    def run(self, flat, in_offset, in_stride, batch, lg_N, rate, tw, pre,
            post):
        """Returns (out [batch, 2^lg_N], launches)."""
        self.flat, self.in_offset, self.in_stride = flat, in_offset, in_stride
        self.lg_N, self.rate, self.tw, self.pre, self.post = \
            lg_N, rate, tw, pre, post
        assert tw.shape == (1 << lg_N,)
        N = 1 << lg_N
        out = torch.full((batch, N), -1, dtype=torch.int64)
        self.stages_run = []
        if lg_N <= self.row_lg:                               # `ntt_row`
            for row in range(batch):
                s = self.stages_shared(self.gather(row, 0, lg_N), lg_N, rate)
                out[row] = self.finish(s, torch.arange(N))
            assert self.stages_run == list(range(rate, lg_N)) * batch
            return out, 1
        T = self.pass_a_tile(batch, lg_N, rate)
        c = lg_N - T
        assert lg_N <= self.max_lg and 1 <= c <= 2 * self.max_col_lg - 1
        assert rate <= T
        self.tile = T
        tiles = []
        for blk in range(batch << c):                         # `ntt_tiles`
            row, t = blk >> c, int(_rev(np.array(blk & ((1 << c) - 1)), c))
            tiles.append((row, t))
            s = self.stages_shared(self.gather(row, t << T, T), T, rate)
            out[row, t << T:(t + 1) << T] = s
        assert sorted(tiles) == [(r, t) for r in range(batch)
                                 for t in range(1 << c)]
        rounds = self.column_rounds(lg_N, T)
        for k, (s0, C) in enumerate(rounds):                  # `ntt_columns`
            r = np.arange(1 << (lg_N - C))
            u = r & ((1 << s0) - 1)
            base = u | ((r >> s0) << (s0 + C))
            idx = torch.as_tensor(base[:, None] + (np.arange(1 << C) << s0))
            assert sorted(idx.reshape(-1).tolist()) == list(range(N))
            last = k == len(rounds) - 1
            for row in range(batch):
                v = self.butterflies(out[row][idx], s0, u, C)
                out[row][idx] = self.finish(v, idx) if last else v
        assert [st for s0, C in rounds for st in range(s0, s0 + C)] == \
            list(range(T, lg_N))
        return out, 1 + len(rounds)


def _model_forward(sched, x, rate_bits, shift):
    """The wrapper `forward` as it calls the kernel, on the model."""
    n = x.shape[-1]
    lg_n = n.bit_length() - 1
    pre = None if shift is None else ntt._shift_powers(shift, n, "cpu")
    out, launches = sched.run(x.reshape(-1), 0, n, x.numel() // n,
                              lg_n + rate_bits, rate_bits,
                              ntt.stage_twiddles(lg_n + rate_bits, False,
                                                 "cpu"), pre, None)
    return out.reshape(x.shape[:-1] + (n << rate_bits,)), launches


def _model_inverse(sched, v, shift):
    n = v.shape[-1]
    lg_n = n.bit_length() - 1
    out, launches = sched.run(v.reshape(-1), 0, n, v.numel() // n, lg_n, 0,
                              ntt.stage_twiddles(lg_n, True, "cpu"), None,
                              ntt.inverse_scale(shift, n, "cpu"))
    return out.reshape(v.shape), launches


KERNEL = ("kRowLg", "kTileLg", "kMinTileLg", "kMinBlocks", "kShrinkColLg",
          "kMaxColLg", "kRadixLg", "kMaxLg")
# reduced tiles: rows of 2^7..2^13 run both passes over several tiles,
# and batches of 1..3 shrink them
SMALL = dict(row_lg=6, tile_lg=7, min_tile_lg=4, min_blocks=8,
             shrink_col_lg=3, max_col_lg=6)


def _kernel_schedule():
    return _Schedule(*(_kernel_constant(name) for name in KERNEL))


def test_schedule_constants_mirror_the_kernel():
    assert [_kernel_constant(name) for name in KERNEL] == \
        [10, 13, 9, 512, 4, 6, 3, 24]
    assert ntt.MAX_LG == _kernel_constant("kMaxLg")
    sched = _kernel_schedule()
    # rows up to 2^19 keep one column round; above it two, up to 2^24
    assert [len(sched.column_rounds(lg, sched.pass_a_tile(b, lg, r)))
            for b, lg, r in [(135, 17, 3), (1, 19, 3), (1, 20, 3),
                             (2, 20, 0), (1, 24, 3), (1, 24, 0)]] == \
        [1, 1, 2, 2, 2, 2]
    # the first round, unreduced, is the smaller: 3 to 5 stages
    assert sched.column_rounds(24, 13) == [(13, 5), (18, 6)]
    assert sched.column_rounds(20, 13) == [(13, 3), (16, 4)]
    assert ntt.MAX_LG - sched.tile_lg == 2 * sched.max_col_lg - 1
    # the prover's calls: tiles of 2^13 for [135|20|16, 2^17] and [2, 2^17]
    # (pass B's columns stay at 2^4), 2^12 for [135, 2^14], 2^10 for
    # [20, 2^14], 2^9 for the fold [2, 2^13]
    assert [sched.pass_a_tile(*c) for c in [
        (135, 17, 3), (20, 17, 3), (16, 17, 3), (2, 17, 0), (135, 14, 0),
        (84, 14, 0), (20, 14, 0), (2, 13, 0)]] == [13, 13, 13, 13, 12, 11,
                                                   10, 9]
    # the kernel's own sizes: a 2^14 LDE of one row, two passes of 2^10
    # tiles
    x = gl.from_u64(_rand(1, 1 << 11), "cpu")
    got, launches = _model_forward(sched, x, 3, G)
    assert launches == 2 and sched.tile == 10
    np.testing.assert_array_equal(
        gl.to_u64(got), jntt.coset_lde(GF.from_u64(gl.to_u64(x)), 3).to_u64())


@pytest.mark.parametrize("name", ["coset_lde", "lde_fft", "ifft",
                                  "coset_ifft", "coset_fft"])
@pytest.mark.parametrize("lg_n", range(1, 11))
def test_schedule_model_vs_jax(name, lg_n):
    """Over rate_bits 0..3 for the LDEs, batch 1..3 and the prover's and
    FRI's shifts: the model on the wrapper's tables equals the reference."""
    sched = _Schedule(**SMALL)
    batch = 1 + lg_n % 3
    shift = SHIFTS[lg_n % len(SHIFTS)]
    rates = range(4) if name.endswith("lde") or name == "lde_fft" else [0]
    for rate_bits in rates:
        x = _rand(batch, 1 << lg_n)
        t = gl.from_u64(x, "cpu")
        if name == "coset_lde":
            got, launches = _model_forward(sched, t, rate_bits, shift)
            want = jntt.coset_lde(GF.from_u64(x), rate_bits, shift)
        elif name == "lde_fft":
            got, launches = _model_forward(sched, t, rate_bits, None)
            want = jntt.lde_fft(GF.from_u64(x), rate_bits)
        elif name == "coset_fft":
            got, launches = _model_forward(sched, t, 0, shift)
            want = jntt.coset_fft(GF.from_u64(x), shift)
        elif name == "ifft":
            got, launches = _model_inverse(sched, t, None)
            want = jntt.ifft(GF.from_u64(x))
        else:
            got, launches = _model_inverse(sched, t, shift)
            want = jntt.coset_ifft(GF.from_u64(x), shift)
        assert launches == (1 if lg_n + rate_bits <= SMALL["row_lg"] else 2)
        np.testing.assert_array_equal(gl.to_u64(got), want.to_u64(),
                                      err_msg=f"{name} 2^{lg_n} r{rate_bits}")


@pytest.mark.parametrize("name,lg_N,rate_bits,batch", [
    ("coset_lde", 14, 3, 2), ("coset_lde", 15, 2, 1), ("coset_lde", 16, 3, 1),
    ("lde_fft", 16, 1, 1), ("coset_fft", 14, 0, 1), ("ifft", 14, 0, 2),
    ("ifft", 16, 0, 1), ("coset_ifft", 15, 0, 1), ("coset_ifft", 16, 0, 1)])
def test_schedule_model_second_column_round_vs_jax(name, lg_N, rate_bits,
                                                   batch):
    """Rows past tile_lg + max_col_lg (2^13 under SMALL, 2^19 on the card)
    take two column rounds, three launches: the model equals the JAX NTT."""
    sched = _Schedule(**SMALL)
    lg_n = lg_N - rate_bits
    shift = SHIFTS[lg_N % len(SHIFTS)]
    x = _rand(batch, 1 << lg_n)
    t = gl.from_u64(x, "cpu")
    if name == "coset_lde":
        got, launches = _model_forward(sched, t, rate_bits, shift)
        want = jntt.coset_lde(GF.from_u64(x), rate_bits, shift)
    elif name == "lde_fft":
        got, launches = _model_forward(sched, t, rate_bits, None)
        want = jntt.lde_fft(GF.from_u64(x), rate_bits)
    elif name == "coset_fft":
        got, launches = _model_forward(sched, t, 0, shift)
        want = jntt.coset_fft(GF.from_u64(x), shift)
    elif name == "ifft":
        got, launches = _model_inverse(sched, t, None)
        want = jntt.ifft(GF.from_u64(x))
    else:
        got, launches = _model_inverse(sched, t, shift)
        want = jntt.coset_ifft(GF.from_u64(x), shift)
    assert launches == 3 and len(sched.column_rounds(lg_N, sched.tile)) == 2
    np.testing.assert_array_equal(gl.to_u64(got), want.to_u64(),
                                  err_msg=f"{name} 2^{lg_N} r{rate_bits}")


@pytest.mark.parametrize("name", ["fft_ext", "coset_fft_ext",
                                  "coset_lde_ext"])
@pytest.mark.parametrize("lg_n", [5, 9])
def test_schedule_model_stacked_ext_vs_jax(name, lg_n):
    """`forward_ext` as the card runs it: c0 and c1 in one call, the second
    row read at its distance from the first (here 3n, with a gap)."""
    sched = _Schedule(**SMALL)
    n = 1 << lg_n
    x0, x1 = _rand(n), _rand(n)
    flat = gl.from_u64(np.concatenate([_rand(5), x0, _rand(2 * n), x1]),
                       "cpu")
    rate_bits = 3 if name == "coset_lde_ext" else 0
    shift = {"fft_ext": None, "coset_fft_ext": SHIFTS[lg_n % len(SHIFTS)],
             "coset_lde_ext": G}[name]
    out, _ = sched.run(flat, 5, 3 * n, 2, lg_n + rate_bits, rate_bits,
                       ntt.stage_twiddles(lg_n + rate_bits, False, "cpu"),
                       None if shift is None else
                       ntt._shift_powers(shift, n, "cpu"), None)
    jx = JGF2(GF.from_u64(x0), GF.from_u64(x1))
    if name == "fft_ext":
        want = jntt.fft_ext(jx)
    elif name == "coset_fft_ext":
        want = jntt.coset_fft_ext(jx, shift)
    else:
        want = JGF2(jntt.coset_lde(jx.c0, 3), jntt.coset_lde(jx.c1, 3))
    np.testing.assert_array_equal(gl.to_u64(out), _jax_pair(want))
    args = {"fft_ext": (), "coset_fft_ext": (shift,), "coset_lde_ext": (3,)}
    got = getattr(ntt, name)(GF2(gl.from_u64(x0, "cpu"),
                                 gl.from_u64(x1, "cpu")), *args[name])
    np.testing.assert_array_equal(
        np.stack([gl.to_u64(got.c0), gl.to_u64(got.c1)]), _jax_pair(want))


@pytest.mark.parametrize("dim,step", [(0, 1), (1, 1), (1, 4), (-1, 2)])
def test_leaf_order(dim, step):
    """Element i along `dim` is the one at the bit-reversal of i step; with
    step 1 the gather is its own inverse."""
    x = torch.arange(8 * 16 * 4).reshape(8, 16, 4)
    n = x.shape[dim]
    got = ntt.leaf_order(x, dim, step)
    want = x.index_select(dim, torch.as_tensor(
        [reverse_bits(i * step, log2_strict(n)) for i in range(n // step)]))
    assert torch.equal(got, want)
    if step == 1:
        assert torch.equal(ntt.leaf_order(got, dim), x)


def test_stage_twiddles_and_inverse_scale():
    """Entry 2^s + j of the table is w_(2^(s+1))^(+-j); the scale is
    shift^(-i) / n."""
    lg = 6
    for inverse in (False, True):
        tw = gl.to_ints(ntt.stage_twiddles(lg, inverse, "cpu"))
        assert len(tw) == 1 << lg and tw[0] == 1
        for s in range(lg):
            w = ref.primitive_root_of_unity(s + 1)
            if inverse:
                w = ref.inverse(w)
            assert tw[1 << s:2 << s] == [ref.exp(w, j) for j in range(1 << s)]
    n_inv = ref.inverse_2exp(lg)
    assert gl.to_ints(ntt.inverse_scale(None, 1 << lg, "cpu")) == \
        [n_inv] * (1 << lg)
    assert gl.to_ints(ntt.inverse_scale(G, 1 << lg, "cpu")) == [
        ref.mul(n_inv, ref.exp(ref.inverse(G), i)) for i in range(1 << lg)]


def test_wrappers_reject_rows_past_the_kernels_limit():
    """Above 2^24 points the kernel path raises before any launch."""
    x = torch.zeros(1 << 22, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="at most 2\\^24"):
        ntt._forward_rows(x, 1 << 22, 1, (1,), 3, None)


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, dtype=torch.int64, device="meta")
    for fn in (ntt.fft, ntt.ifft):
        with pytest.raises(ValueError):
            fn(x)
