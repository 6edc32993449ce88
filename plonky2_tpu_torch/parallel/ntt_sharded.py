"""Four-step (Bailey) NTT sharded over the ranks of a mesh axis: one
polynomial spans the ranks, so it may be longer than one card's K1 takes
(2^24 points) or holds (the JAX package's parallel/ntt_sharded.py).

Math: N = N1 N2, j = j1 N2 + j2, k = k2 N1 + k1, w = w_N. Then

  X[k2 N1 + k1] = sum_{j2} w_{N2}^{j2 k2} ( w_N^{j2 k1}
                  sum_{j1} x[j1 N2 + j2] w_{N1}^{j1 k1} )

over the [N2, N1] matrix M[j2][j1] = x[j1 N2 + j2], each rank holding a
block of N2 / D rows:
  0. (coset) x[j] shift^j = M[j2][j1] (shift^N2)^j1 shift^j2: the row
     factor shift^j2 is a plain multiply, the column factor is the shift
     power table of K1's forward entry (`ntt.forward(m, rate, shift^N2)`);
  1. an N1-point transform along each row: K1 (`ntt.forward`); for an LDE
     only the first N1 / 2^rate_bits entries of a row are non-zero, so it
     is K1's LDE at rate_bits;
  2. the middle twiddles w_N^{j2 k1}: plain multiplies, the table factored
     as U[j2 >> h][k1] V[j2 & (2^h - 1)][k1] with h = lg N2 // 2;
  3. all_to_all: rows j2 -> columns k1 (the distributed transpose);
  4. an N2-point transform along each column: K1;
and a last all_to_all to natural output order, each rank holding [N / D].

The exchanges are `all_to_all_single` on the axis's process group. A batch
(`coset_lde_large_batch`) spans a 2-D mesh: polynomials over the first axis,
each one's transform over the second; its exchanges stay on the second.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..field import goldilocks as gl
from ..field import reference as ref
from ..ops import ntt
from ..utils.bits import log2_strict
from ..utils.timing import null_timing


def _powers_rows(bases: torch.Tensor, n: int) -> torch.Tensor:
    """[R] bases -> [R, n] rows of their powers, by doubling."""
    out = torch.ones((bases.shape[0], 1), dtype=torch.int64,
                     device=bases.device)
    p = bases
    while out.shape[1] < n:
        out = torch.cat([out, gl.mul(out, p.unsqueeze(1))], dim=1)
        p = gl.mul(p, p)
    return out[:, :n]


@lru_cache(maxsize=None)
def _twiddle_factor_tables(lg_n: int, lg_n1: int, lg_n2: int, device):
    """U [2^(lg_n2 - h), N1], V [2^h, N1] with w_N^{j2 k1} =
    U[j2 >> h][k1] V[j2 & (2^h - 1)][k1], h = lg_n2 // 2."""
    n1 = 1 << lg_n1
    h = lg_n2 // 2
    w = ref.primitive_root_of_unity(lg_n)
    u = _powers_rows(gl.powers(ref.exp(w, 1 << h), 1 << (lg_n2 - h), device),
                     n1)
    v = _powers_rows(gl.powers(w, 1 << h, device), n1)
    return u, v, h


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single of x [D, ...]: block r goes to rank r of `group`;
    the result's block r came from rank r."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _four_step(m: torch.Tensor, lg_n: int, lg_n2: int, group, d: int,
               idx: int, rate_bits: int, shift: int | None,
               timing) -> torch.Tensor:
    """m [b, N2 / D, n_cols]: rank idx's rows of the input matrices (n_cols
    = N1 / 2^rate_bits). Returns [b, N / D], this rank's block of each
    natural-order output."""
    lg_n1 = lg_n - lg_n2
    n1, n2 = 1 << lg_n1, 1 << lg_n2
    rows = n2 // d
    b = m.shape[0]
    dev = m.device
    col_shift = None
    if shift is not None:
        with timing.scope("row factor", dev):
            row_pows = ntt._shift_powers(shift, n2, m.device)[
                idx * rows:(idx + 1) * rows]
            m = gl.mul(m, row_pows.view(1, rows, 1))
        col_shift = ref.exp(shift, n2)
    with timing.scope("step 1: K1", dev):
        y = ntt.forward(m.contiguous(), rate_bits, col_shift)   # [b, rows, N1]
    with timing.scope("middle twiddles", dev):
        u, v, h = _twiddle_factor_tables(lg_n, lg_n1, lg_n2, m.device)
        j2 = torch.arange(idx * rows, (idx + 1) * rows, device=m.device)
        tw = gl.mul(u.index_select(0, j2 >> h),
                    v.index_select(0, j2 & ((1 << h) - 1)))
        y = gl.mul(y, tw)
        del tw
    with timing.scope("exchange 1", dev):
        # [b, rows, D, N1 / D] -> block r: this rank's rows, k1 chunk r
        z = _exchange(y.view(b, rows, d, n1 // d).permute(2, 0, 1, 3), group)
        del y
        zt = z.permute(1, 3, 0, 2).reshape(b, n1 // d, n2)     # [b, k1, j2]
        del z
    with timing.scope("step 4: K1", dev):
        zt = ntt.forward(zt.contiguous())                      # [b, k1, k2]
    with timing.scope("exchange 2", dev):
        x = _exchange(zt.view(b, n1 // d, d, n2 // d).permute(2, 0, 1, 3),
                      group)                       # [D, b, N1 / D, N2 / D]
        del zt
        # X[k2 N1 + k1] for this rank's k2: [b, k2, k1]
        out = x.permute(1, 3, 0, 2).reshape(b, (n2 // d) * n1)
    return out


def _split(lg_n: int, d: int, rate_bits: int, lg_n2: int | None) -> int:
    """The default split keeps both transforms near sqrt(N) and N2
    divisible by D."""
    if lg_n2 is None:
        lg_n2 = max((lg_n + 1) // 2, (d - 1).bit_length() + 1
                    if d > 1 else 1)
    if (1 << lg_n2) % d:
        raise ValueError("N2 must be divisible by the mesh size")
    if not lg_n2 < lg_n:
        raise ValueError("need at least two columns")
    if lg_n - lg_n2 < rate_bits:
        raise ValueError("N1 must cover the blowup")
    return lg_n2


def _check_device(t: torch.Tensor, mesh: DeviceMesh, what: str) -> None:
    if t.device.type != mesh.device_type:
        raise ValueError(f"{what}: a {t.device.type} tensor on a "
                         f"{mesh.device_type} mesh")


def _input_rows(coeffs, n2: int, in_cols: int, rows: int, d: int, idx: int,
                group) -> torch.Tensor:
    """This rank's rows M[j2][j1] = x[j1 N2 + j2], j2 in its block, from a
    whole vector on every rank, or from a DTensor sharded in contiguous
    blocks of x (one all_to_all: block r' of this rank's j1 range goes to
    rank r')."""
    if isinstance(coeffs, DTensor):
        if not isinstance(coeffs.placements[0], Shard):
            return _input_rows(coeffs.to_local(), n2, in_cols, rows, d, idx,
                               group)
        local = coeffs.to_local()
        if in_cols % d:
            raise ValueError(f"a sharded input needs {d} | {in_cols} columns")
        got = _exchange(local.view(in_cols // d, d, rows).permute(1, 0, 2),
                        group)                      # [D, in_cols / D, rows]
        return got.reshape(in_cols, rows).t().unsqueeze(0)
    return coeffs.view(in_cols, n2)[:, idx * rows:(idx + 1) * rows].t() \
        .unsqueeze(0)


def _dispatch(coeffs, mesh: DeviceMesh, rate_bits: int, shift: int | None,
              lg_n2: int | None, timing) -> DTensor:
    if mesh.ndim != 1:
        raise ValueError("fft_large and coset_lde_large take a 1-D mesh")
    (n_in,) = coeffs.shape
    _check_device(coeffs, mesh, "coset_lde_large")
    lg_n = log2_strict(n_in) + rate_bits
    d = mesh.size()
    lg_n2 = _split(lg_n, d, rate_bits, lg_n2)
    n2 = 1 << lg_n2
    in_cols = n_in // n2
    group = mesh.get_group()
    idx = mesh.get_local_rank()
    m = _input_rows(coeffs, n2, in_cols, n2 // d, d, idx, group)
    out = _four_step(m, lg_n, lg_n2, group, d, idx, rate_bits, shift,
                     timing or null_timing())
    return DTensor.from_local(out[0], mesh, [Shard(0)], run_check=False)


def fft_large(coeffs, mesh: DeviceMesh, lg_n2: int | None = None,
              timing=None) -> DTensor:
    """Natural-order NTT of one length-N vector over a 1-D mesh: `coeffs`
    whole on every rank, or a DTensor (`multihost.host_local_to_global`);
    the result is a DTensor, each rank holding [N / D]."""
    return _dispatch(coeffs, mesh, 0, None, lg_n2, timing)


def coset_lde_large(coeffs, mesh: DeviceMesh, rate_bits: int,
                    shift: int = ref.MULTIPLICATIVE_GROUP_GENERATOR,
                    lg_n2: int | None = None, timing=None) -> DTensor:
    """`ntt.coset_lde` of one polynomial over a 1-D mesh: output on the
    2^rate_bits times larger coset, natural order, each rank holding
    [N / D]. `timing`: a TimingTree that scopes the four steps and the two
    exchanges."""
    return _dispatch(coeffs, mesh, rate_bits, shift, lg_n2, timing)


def lde_batch_local(coeffs: torch.Tensor, mesh: DeviceMesh, rate_bits: int,
                    shift: int | None = ref.MULTIPLICATIVE_GROUP_GENERATOR,
                    lg_n2: int | None = None) -> torch.Tensor:
    """This rank's block [B / C, N / S] of the coset LDE of coeffs [B, n]
    (whole on every rank) over a 2-D mesh (C, S): rank (c, s) holds points
    [s N / S, (s + 1) N / S) of polynomials [c B / C, (c + 1) B / C)."""
    if mesh.ndim != 2:
        raise ValueError("coset_lde_large_batch takes a 2-D mesh")
    _check_device(coeffs, mesh, "coset_lde_large_batch")
    bsz, n_in = coeffs.shape
    c, s = mesh.shape
    if bsz % c:
        raise ValueError(f"{bsz} polynomials on {c} column ranks")
    lg_n = log2_strict(n_in) + rate_bits
    lg_n2 = _split(lg_n, s, rate_bits, lg_n2)
    n2 = 1 << lg_n2
    in_cols = n_in // n2
    rows = n2 // s
    seq_axis = mesh.mesh_dim_names[1]
    ci, si = mesh.get_local_rank(mesh.mesh_dim_names[0]), \
        mesh.get_local_rank(seq_axis)
    b = bsz // c
    m = coeffs[ci * b:(ci + 1) * b].reshape(b, in_cols, n2)[
        :, :, si * rows:(si + 1) * rows].transpose(1, 2)
    return _four_step(m, lg_n, lg_n2, mesh.get_group(seq_axis), s, si,
                      rate_bits, shift, null_timing())


def coset_lde_large_batch(coeffs: torch.Tensor, mesh: DeviceMesh,
                          rate_bits: int,
                          shift: int = ref.MULTIPLICATIVE_GROUP_GENERATOR,
                          lg_n2: int | None = None) -> DTensor:
    """The coset LDE of coeffs [B, n] over a 2-D mesh (C, S), B % C == 0:
    polynomials data-parallel over the first axis, each one's four-step
    transform over the S ranks of the second. A DTensor [B, N] in natural
    order, sharded over both axes."""
    out = lde_batch_local(coeffs, mesh, rate_bits, shift, lg_n2)
    return DTensor.from_local(out, mesh, [Shard(0), Shard(1)],
                              run_check=False)
