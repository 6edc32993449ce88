"""Batched Goldilocks NTT / iNTT / coset LDE on the last axis.

Semantics of plonky2_tpu/ops/ntt.py: radix-2 DIT after a bit-reversal;
ifft = forward FFT, index reversal j -> (n - j) mod n, scale by 1/n; a coset
transform scales the coefficients by powers of the shift; the LDE folds the
shift in BEFORE the zero padding and skips the first rate_bits butterfly
stages (each bit-reversed coefficient repeated 2^rate_bits times).

The butterfly network is kernel K1 (`csrc/ntt.cu`): `dit()` launches it for a
CUDA tensor and runs `dit_plain()` for a CPU tensor. Bit-reversal, the coset
shift and the 1/n scale stay as torch ops around it.
"""

from __future__ import annotations

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


@lru_cache(maxsize=None)
def half_twiddles(lg_n: int, device) -> torch.Tensor:
    """w^0 .. w^{n/2-1} for the primitive 2^lg_n-th root of unity w."""
    n = 1 << lg_n
    return gl.powers(ref.primitive_root_of_unity(lg_n), max(n // 2, 1),
                     device)


@lru_cache(maxsize=None)
def _perm(kind: str, n: int, device) -> torch.Tensor:
    p = reverse_index_bits_perm(n) if kind == "rev" else ifft_reverse_perm(n)
    return torch.as_tensor(p, dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    return gl.powers(shift, n, device)


def dit_plain(x: torch.Tensor, start_stage: int) -> torch.Tensor:
    """Plain PyTorch version of K1: stages [start_stage, lg_n) of the radix-2
    DIT network over the last axis (bit-reversed in, natural order out)."""
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


def dit(x: torch.Tensor, start_stage: int) -> torch.Tensor:
    """K1 wrapper: the kernel for a CUDA tensor, `dit_plain` for a CPU one."""
    n = x.shape[-1]
    lg_n = log2_strict(n)
    if backend.plain_path(x, "ntt_dit"):
        return dit_plain(x, start_stage)
    if start_stage >= lg_n:
        return x
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    out.copy_(x)
    backend.require_cuda_int64(out, "ntt_dit")
    tw = half_twiddles(lg_n, x.device)
    batch = out.numel() // n
    rc = backend.lib().ntt_dit(out.data_ptr(), tw.data_ptr(), batch, lg_n,
                               start_stage, backend.stream(out))
    backend.check(rc, "ntt_dit")
    backend.KERNELS["ntt_dit"].launched((batch, lg_n, start_stage))
    return out


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    """values[j] = P(g^j) over the size-n two-adic subgroup; last axis."""
    n = coeffs.shape[-1]
    return dit(coeffs.index_select(-1, _perm("rev", n, coeffs.device)), 0)


def ifft(values: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1]
    buf = fft(values).index_select(-1, _perm("ifft", n, values.device))
    return gl.mul_const(buf, ref.inverse_2exp(log2_strict(n)))


def coset_fft(coeffs: torch.Tensor,
              shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    n = coeffs.shape[-1]
    return fft(gl.mul(coeffs, _shift_powers(shift, n, coeffs.device)))


def coset_ifft(values: torch.Tensor,
               shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    n = values.shape[-1]
    return gl.mul(ifft(values),
                  _shift_powers(ref.inverse(shift), n, values.device))


def lde_fft(coeffs: torch.Tensor, rate_bits: int,
            shift: int | None = None) -> torch.Tensor:
    """Evaluate on a 2^rate_bits-times larger (coset of the) subgroup,
    skipping the first rate_bits butterfly stages."""
    n = coeffs.shape[-1]
    if shift is not None:
        coeffs = gl.mul(coeffs, _shift_powers(shift, n, coeffs.device))
    x = coeffs.index_select(-1, _perm("rev", n, coeffs.device))
    if rate_bits:
        x = x.repeat_interleave(1 << rate_bits, dim=-1)
    return dit(x, rate_bits)


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """PolynomialCoeffs::lde().coset_fft(): the shift powers apply to the
    padded coefficient vector, so they are folded in before padding."""
    return lde_fft(coeffs, rate_bits, shift=shift)


def fft_ext(coeffs: GF2) -> GF2:
    return GF2(fft(coeffs.c0), fft(coeffs.c1))


def coset_fft_ext(coeffs: GF2,
                  shift: int = MULTIPLICATIVE_GROUP_GENERATOR) -> GF2:
    return GF2(coset_fft(coeffs.c0, shift), coset_fft(coeffs.c1, shift))
