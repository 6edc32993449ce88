"""Batched Goldilocks NTT / iNTT / coset LDE on the last axis.

Semantics of plonky2_tpu/ops/ntt.py: radix-2 DIT after a bit-reversal;
ifft = forward FFT, index reversal j -> (n - j) mod n, scale by 1/n; a coset
transform scales the coefficients by powers of the shift; the LDE folds the
shift in BEFORE the zero padding and skips the first rate_bits butterfly
stages (each bit-reversed coefficient repeated 2^rate_bits times).

Every transform is one call of kernel K1 (`csrc/ntt.cu`) for a CUDA tensor:
`forward` (the coset LDE, and fft / coset_fft at rate 0) or `inverse`
(ifft / coset_ifft). Beside the launch the wrapper allocates the output and,
on first use of a size, shift or direction, builds the cached twiddle, shift
and scale tables. A CPU tensor takes the plain versions, `forward_plain` and
`inverse_plain`: the composition of the shift multiply, the bit-reversal
gather, the repeat and the butterfly stages of `dit_plain`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import backend
from ..field import goldilocks as gl
from ..field import reference as ref
from ..field.extension import GF2
from ..utils.bits import (
    ifft_reverse_perm, log2_strict, reverse_index_bits_perm,
)

MULTIPLICATIVE_GROUP_GENERATOR = ref.MULTIPLICATIVE_GROUP_GENERATOR
# K1's longest row, 2^MAX_LG points (`kMaxLg` of csrc/ntt.cu): the
# reference's NTT range, 2^12 to 2^24
MAX_LG = 24


@lru_cache(maxsize=None)
def half_twiddles(lg_n: int, device) -> torch.Tensor:
    """w^0 .. w^{n/2-1} for the primitive 2^lg_n-th root of unity w."""
    n = 1 << lg_n
    return gl.powers(ref.primitive_root_of_unity(lg_n), max(n // 2, 1),
                     device)


@lru_cache(maxsize=None)
def stage_twiddles(lg_n: int, inverse: bool, device) -> torch.Tensor:
    """K1's table of n entries, stage-major: entry 2^s + j is w^j for w the
    primitive 2^(s+1)-th root of unity (its inverse for the inverse
    transform), j < 2^s; entry 0 is 1."""
    root = ref.primitive_root_of_unity(lg_n)
    half = gl.powers(ref.inverse(root) if inverse else root,
                     max((1 << lg_n) // 2, 1), device)
    return torch.cat([gl.const(1, device, (1,))] + [
        half[::1 << (lg_n - 1 - s)][:1 << s] for s in range(lg_n)])


@lru_cache(maxsize=None)
def _perm(kind: str, n: int, device) -> torch.Tensor:
    p = reverse_index_bits_perm(n) if kind == "rev" else ifft_reverse_perm(n)
    return torch.as_tensor(p, dtype=torch.int64, device=device)


def leaf_order(x: torch.Tensor, dim: int, step: int = 1) -> torch.Tensor:
    """x gathered along `dim` at the bit-reversed indices of its length,
    every `step`-th of them: natural order to the Merkle leaves' order, and
    back, and with a step the natural points of a 1/step subsampled LDE."""
    return x.index_select(dim, _perm("rev", x.shape[dim], x.device)[::step])


@lru_cache(maxsize=None)
def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    return gl.powers(shift, n, device)


@lru_cache(maxsize=None)
def inverse_scale(shift: int | None, n: int, device) -> torch.Tensor:
    """The inverse's store scale: shift^(-i) / n (1 / n without a shift)."""
    n_inv = ref.inverse_2exp(log2_strict(n))
    if shift is None:
        return gl.const(n_inv, device, (n,))
    return gl.mul_const(_shift_powers(ref.inverse(shift), n, device), n_inv)


def dit_plain(x: torch.Tensor, start_stage: int) -> torch.Tensor:
    """Stages [start_stage, lg_n) of the radix-2 DIT network over the last
    axis (bit-reversed in, natural order out)."""
    n = x.shape[-1]
    lg_n = log2_strict(n)
    tw = half_twiddles(lg_n, x.device)
    y = x.reshape(-1, n)
    for s in range(start_stage, lg_n):
        m = 1 << s
        w = tw[::1 << (lg_n - 1 - s)][:m]
        yr = y.reshape(y.shape[0], n // (2 * m), 2, m)
        u, t = yr[:, :, 0], gl.mul(yr[:, :, 1], w)
        y = torch.stack([gl.add(u, t), gl.sub(u, t)], dim=2).reshape(-1, n)
    return y.reshape(x.shape)


def forward_plain(coeffs: torch.Tensor, rate_bits: int,
                  shift: int | None) -> torch.Tensor:
    """Plain PyTorch version of K1's forward entry."""
    n = coeffs.shape[-1]
    if shift is not None:
        coeffs = gl.mul(coeffs, _shift_powers(shift, n, coeffs.device))
    x = leaf_order(coeffs, -1)
    if rate_bits:
        x = x.repeat_interleave(1 << rate_bits, dim=-1)
    return dit_plain(x, rate_bits)


def inverse_plain(values: torch.Tensor, shift: int | None) -> torch.Tensor:
    """Plain PyTorch version of K1's inverse entry."""
    n = values.shape[-1]
    buf = forward_plain(values, 0, None).index_select(
        -1, _perm("ifft", n, values.device))
    out = gl.mul_const(buf, ref.inverse_2exp(log2_strict(n)))
    if shift is not None:
        out = gl.mul(out, _shift_powers(ref.inverse(shift), n, values.device))
    return out


def _check_size(entry: str, lg_N: int) -> None:
    if lg_N > MAX_LG:
        raise ValueError(f"{entry}: K1 takes rows of at most 2^{MAX_LG} "
                         f"points, got 2^{lg_N}")


def _launch(entry: str, shape: tuple, out: torch.Tensor, *args) -> None:
    """K1's C entry `entry` on `args` (the output's pointer first) on the
    output's device."""
    launches = ctypes.c_int(0)
    rc = backend.call(entry, out, out.data_ptr(), *args,
                      ctypes.byref(launches))
    backend.check(rc, entry)
    for _ in range(launches.value):
        backend.KERNELS["ntt"].launched(shape)


def _forward_rows(x: torch.Tensor, stride: int, batch: int, lead: tuple,
                  rate_bits: int, shift: int | None) -> torch.Tensor:
    """K1's forward entry over `batch` rows of n at `stride` elements from
    x; the output [*lead, n 2^rate_bits]."""
    n = x.shape[-1]
    lg_n = log2_strict(n)
    _check_size("ntt_forward", lg_n + rate_bits)
    out = torch.empty(lead + (n << rate_bits,), dtype=torch.int64,
                      device=x.device)
    if batch:
        sp = None if shift is None else \
            _shift_powers(shift, n, x.device).data_ptr()
        tw = stage_twiddles(lg_n + rate_bits, False, x.device)
        _launch("ntt_forward", (batch, lg_n, rate_bits, "forward", shift),
                out, x.data_ptr(), stride, batch, lg_n, rate_bits,
                sp, tw.data_ptr(), backend.stream(out))
    return out


def forward(coeffs: torch.Tensor, rate_bits: int = 0,
            shift: int | None = None) -> torch.Tensor:
    """K1 forward: out[..., j] = sum_i c[..., i] shift^i w_N^(ij) over
    N = n 2^rate_bits points; the kernel for a CUDA tensor, `forward_plain`
    for a CPU one."""
    if backend.plain_path(coeffs, "ntt_forward"):
        return forward_plain(coeffs, rate_bits, shift)
    backend.require_cuda_int64(coeffs, "ntt_forward")
    n = coeffs.shape[-1]
    return _forward_rows(coeffs, n, coeffs.numel() // n, coeffs.shape[:-1],
                         rate_bits, shift)


def inverse(values: torch.Tensor, shift: int | None = None) -> torch.Tensor:
    """K1 inverse: the coefficients c with values = coset_fft(c, shift)
    (fft without a shift); the kernel for a CUDA tensor, `inverse_plain`
    for a CPU one."""
    if backend.plain_path(values, "ntt_inverse"):
        return inverse_plain(values, shift)
    backend.require_cuda_int64(values, "ntt_inverse")
    n = values.shape[-1]
    lg_n = log2_strict(n)
    _check_size("ntt_inverse", lg_n)
    batch = values.numel() // n
    out = torch.empty(values.shape, dtype=torch.int64, device=values.device)
    if batch:
        _launch("ntt_inverse", (batch, lg_n, 0, "inverse", shift),
                out, values.data_ptr(), batch, lg_n,
                inverse_scale(shift, n, values.device).data_ptr(),
                stage_twiddles(lg_n, True, values.device).data_ptr(),
                backend.stream(out))
    return out


def forward_ext(coeffs: GF2, rate_bits: int = 0,
                shift: int | None = None) -> GF2:
    """`forward` of c0 and c1 of a 1-D extension array in one call: on the
    card the kernel reads the two rows at the distance between them."""
    c0, c1 = coeffs.c0, coeffs.c1
    if backend.plain_path(c0, "ntt_forward"):
        return GF2(forward_plain(c0, rate_bits, shift),
                   forward_plain(c1, rate_bits, shift))
    for c in (c0, c1):
        backend.require_cuda_int64(c, "ntt_forward")
    if c0.dim() != 1 or c1.shape != c0.shape:
        raise ValueError(f"ntt_forward: an extension array of one row, got "
                         f"{tuple(c0.shape)} and {tuple(c1.shape)}")
    out = _forward_rows(c0, (c1.data_ptr() - c0.data_ptr()) // 8, 2, (2,),
                        rate_bits, shift)
    return GF2(out[0], out[1])


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    """values[j] = P(g^j) over the size-n two-adic subgroup; last axis."""
    return forward(coeffs)


def ifft(values: torch.Tensor) -> torch.Tensor:
    return inverse(values)


def coset_fft(coeffs: torch.Tensor,
              shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    return forward(coeffs, 0, shift)


def coset_ifft(values: torch.Tensor,
               shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    return inverse(values, shift)


def lde_fft(coeffs: torch.Tensor, rate_bits: int,
            shift: int | None = None) -> torch.Tensor:
    """Evaluate on a 2^rate_bits-times larger (coset of the) subgroup,
    skipping the first rate_bits butterfly stages."""
    return forward(coeffs, rate_bits, shift)


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """PolynomialCoeffs::lde().coset_fft(): the shift powers apply to the
    padded coefficient vector, so they are folded in before padding."""
    return forward(coeffs, rate_bits, shift)


def coset_lde_ext(coeffs: GF2, rate_bits: int,
                  shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> GF2:
    return forward_ext(coeffs, rate_bits, shift)


def fft_ext(coeffs: GF2) -> GF2:
    return forward_ext(coeffs)


def coset_fft_ext(coeffs: GF2,
                  shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> GF2:
    return forward_ext(coeffs, 0, shift)
