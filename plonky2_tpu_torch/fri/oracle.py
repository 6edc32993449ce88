"""PolynomialBatch — the FRI commitment (reference fri/oracle.rs
from_values:62, from_coeffs:134 with its salt, get_lde_values:474,
prove_openings:508 with the final-poly-times-X tweak at :547).

A commit is: iNTT (from values), coset LDE at rate 2^rate_bits (K1), then
the Merkle tree over the LDE rows in bit-reversed order (the leaves). A
blinded commit (zero knowledge) appends SALT_SIZE random rows to the LDE
before the leaves, drawn from the caller's numpy Generator (an unseeded one
when none is given), so each leaf is num + 4 wide; `natural_lde` and
`get_lde_values(_batch)` drop the salt, the FRI query rounds open it.

`commit_batch` makes B commitments of one shape at once from coefficients
[num, B, n] with the proof axis inside: K1 takes the [num, B, n] rows in one
call, the LDE [num(+4), B, N] is the [num(+4), B N] leaf columns of all B
trees (K3 or K7 hashes them in one call), and the B trees side by side, each
proof's leaves contiguous, are one tree at cap height cap_height + log2 B
whose layers below the B caps never mix two proofs (one call of the tree
entry of K2 or K6; a B that is no power of two splits into its binary runs,
a call each). Each proof's layers are views of those. A host hasher
(Keccak, PoseidonBN128) hashes each proof's leaves on the host
(`MerkleTree`).

Under `parallel.sharding.prover_mesh(mesh)` a commit runs column-parallel
over the mesh's ranks (`commit_values_sharded`: each rank's rows through
K1, one all_to_all to the ranks' leaf blocks, each rank's subtree through
K3/K7 and K2/K6, one all_gather of the leaves and layers), and every rank
gets the single-device tree, bit for bit. It shards what the JAX package's
`PolynomialBatch._sharded` shards, an unblinded commit under a device
hasher: `from_values` (the iNTT too), `from_coeffs` and `commit_batch` of
one proof. These keep the single-device commit, as there: a blinded (zero
knowledge) commit, a host hasher's (Keccak, PoseidonBN128), and
`commit_batch` of B > 1 proofs (`batch_prover.prove_batch`). That is the
reference's semantics, not a fallback: the mesh never changes a proof.

`prove_openings` scopes its phases on the thread's active TimingTree
(`utils/timing.scope`): the alpha draw (`challenges`), `reduce batch of
polynomials` (the alpha reduction and division of every opened batch) and
`perform final FFT` (the final polynomial's LDE), then `fri_proof`'s. A
commit's trees under a device hasher are built in the span `merkle trees`
(the leaf hash, the digests' leaf order and the layers), which adds the B
trees to the counter `merkle_trees`; a host hasher's trees open it in
`MerkleTree`, and the mesh commit's, its leaf exchange included, in
`sharding._tree_from_blocks`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from ..field.extension import GF2
from ..hash.merkle import MerkleTree
from ..iop.challenger import Challenger
from ..ops import ntt
from ..ops.polynomial import (
    divide_by_linear, mul_poly_by_x, reduce_polys_base,
)
from ..parallel import sharding
from ..utils import timing as tracing
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .prover import fri_proof
from .structure import FriInstanceInfo

SALT_SIZE = 4


class PolynomialBatch:
    """polynomials: int64 [num_polys, 2^degree_log] coefficient rows; the
    tree's leaves are [N, num_polys (+ SALT_SIZE when blinding)]."""

    def __init__(self, polynomials: torch.Tensor, merkle_tree: MerkleTree,
                 degree_log: int, rate_bits: int, blinding: bool = False):
        self.polynomials = polynomials
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits
        self.blinding = blinding

    @staticmethod
    def from_values(values: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher) -> "PolynomialBatch":
        sharded = _sharded(values, rate_bits, cap_height, hasher, True)
        if sharded is not None:
            return sharded
        return PolynomialBatch.from_coeffs(ntt.ifft(values), rate_bits,
                                           cap_height, hasher)

    @staticmethod
    def from_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher) -> "PolynomialBatch":
        """An unsalted commit of one batch [num, n] (a salted one is the
        prover's, through `commit_batch`)."""
        return commit_batch(coeffs.unsqueeze(1), rate_bits, cap_height,
                            hasher).batches[0]

    @property
    def lde_bits(self) -> int:
        return self.degree_log + self.rate_bits

    @property
    def salt_size(self) -> int:
        return SALT_SIZE if self.blinding else 0

    def natural_lde(self, step: int) -> torch.Tensor:
        """[num_polys, N / step] LDE values in natural point order."""
        leaves = self.merkle_tree.leaves
        num = leaves.shape[1] - self.salt_size
        return ntt.leaf_order(leaves, 0, step)[:, :num].t()

    def get_lde_values(self, index: int, step: int = 1):
        """Host row of LDE values at point index * step, salt dropped."""
        return self.get_lde_values_batch([index], step)[0]

    def get_lde_values_batch(self, indices, step: int = 1):
        """[k, num_polys] host rows for many points, salt dropped."""
        rows = self.merkle_tree.rows_batch(
            [reverse_bits(int(i) * step, self.lde_bits) for i in indices])
        return rows[:, :rows.shape[1] - self.salt_size]

    @staticmethod
    def prove_openings(instance: FriInstanceInfo, oracles: list,
                       challenger: Challenger, fri_params: FriParams):
        with tracing.scope("challenges"):
            alpha = challenger.get_extension_challenge()
        n = oracles[0].polynomials.shape[-1]
        device = oracles[0].polynomials.device
        with tracing.scope("reduce batch of polynomials", device):
            final = GF2.zeros((n,), device)
            for batch in instance.batches:
                polys = torch.stack([
                    oracles[p.oracle_index].polynomials[p.polynomial_index]
                    for p in batch.polynomials])
                count = len(batch.polynomials)
                quotient = divide_by_linear(reduce_polys_base(polys, alpha),
                                            batch.point)
                shift = GF2.const(ref.ext2_exp(alpha, count), device)
                final = final * shift + quotient

        # multiply by X (the top coefficient is provably zero), then LDE
        with tracing.scope("perform final FFT", device):
            shifted = mul_poly_by_x(final)[:n]
            rate_bits = fri_params.config.rate_bits
            pad = GF2.zeros((n * ((1 << rate_bits) - 1),), device)
            lde_coeffs = GF2.cat([shifted, pad])
            lde_values = ntt.coset_lde_ext(shifted, rate_bits)
        return fri_proof([o.merkle_tree for o in oracles], lde_coeffs,
                         lde_values, challenger, fri_params)


class BatchCommitment:
    """B commitments of one shape made together (`commit_batch`):
    `batches`, one PolynomialBatch a proof, over the shared coefficients
    [num, B, n] and leaves [B, N, num (+ salt)]."""

    def __init__(self, coeffs: torch.Tensor, leaves: torch.Tensor,
                 batches: list):
        self.coeffs = coeffs
        self.leaves = leaves
        self.batches = batches

    def natural_lde(self, step: int) -> torch.Tensor:
        """[num, B, N / step] LDE values in natural point order, salt
        dropped."""
        rows = ntt.leaf_order(self.leaves, 1, step)
        return rows[..., :self.coeffs.shape[0]].permute(2, 0, 1)

    def caps(self) -> list:
        return [b.merkle_tree.cap_digests() for b in self.batches]


def _binary_runs(b: int) -> list[int]:
    """b as powers of two, largest first (3 -> [2, 1])."""
    return [1 << k for k in reversed(range(b.bit_length())) if b >> k & 1]


def _device_trees(leaves: torch.Tensor, digests: torch.Tensor,
                  cap_height: int, hasher) -> list:
    """One MerkleTree a proof over leaves [B, N, L] and their digests
    [B N, 4] in leaf order, proof-major: each binary run of proofs is one
    call of the tree entry at cap height cap_height + log2(run), and a
    proof's layers are its contiguous slice of each level."""
    B, N = leaves.shape[:2]
    trees, start = [], 0
    for run in _binary_runs(B):
        d = digests[start * N:(start + run) * N]
        layers = [d] + hasher.merkle_layers(
            d, cap_height + log2_strict(run))
        for j in range(run):
            trees.append(MerkleTree(
                leaves[start + j], cap_height, hasher,
                layers=[layer.view(run, -1, layer.shape[-1])[j]
                        for layer in layers]))
        start += run
    return trees


def _sharded(x: torch.Tensor, rate_bits: int, cap_height: int, hasher,
             from_values: bool, blinding: bool = False):
    """The commit of rows x [num, n] on the active `prover_mesh`, or None
    where there is none or the commit keeps the single-device path (a
    blinded commit, a host hasher)."""
    mesh = sharding.current_prover_mesh()
    if mesh is None or blinding or not hasher.device:
        return None
    coeffs, leaves, layers = sharding.commit_values_sharded(
        mesh, x, rate_bits, cap_height, from_values, hasher)
    return PolynomialBatch(coeffs, MerkleTree(leaves, cap_height, hasher,
                                              layers=layers),
                           log2_strict(x.shape[1]), rate_bits)


def commit_batch(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                 hasher, blinding: bool = False,
                 rng=None) -> BatchCommitment:
    """Commit the coefficient rows [num, B, n] of B proofs at once; under
    `blinding` each proof's LDE gets SALT_SIZE rows of N random elements
    from `rng`, drawn proof after proof. One unblinded proof under a
    `prover_mesh` commits on the mesh (module docstring)."""
    num, B, n = coeffs.shape
    if B == 1:
        batch = _sharded(coeffs[:, 0], rate_bits, cap_height, hasher, False,
                         blinding)
        if batch is not None:
            return BatchCommitment(coeffs, batch.merkle_tree.leaves[None],
                                   [batch])
    lg_n = log2_strict(n)
    N = n << rate_bits
    device = coeffs.device
    lde = ntt.coset_lde(coeffs, rate_bits)                   # [num, B, N]
    if blinding:
        rng = np.random.default_rng() if rng is None else rng
        salt = np.stack([rng.integers(0, ref.ORDER, size=(SALT_SIZE, N),
                                      dtype=np.uint64) for _ in range(B)],
                        axis=1)
        lde = torch.cat([lde, gl.from_u64(salt, device)])
    width = lde.shape[0]
    leaves = ntt.leaf_order(lde.permute(1, 2, 0), 1)          # [B, N, width]
    if hasher.device:
        with tracing.scope("merkle trees", device):
            digests = hasher.hash_or_noop_columns(lde.reshape(width, B * N))
            digests = ntt.leaf_order(digests.view(B, N, -1), 1).reshape(
                B * N, -1)
            del lde
            trees = _device_trees(leaves, digests, cap_height, hasher)
            tracing.count("merkle_trees", B)
    else:
        del lde
        trees = [MerkleTree(leaves[b], cap_height, hasher) for b in range(B)]
    return BatchCommitment(coeffs, leaves, [
        PolynomialBatch(coeffs[:, b], tree, lg_n, rate_bits, blinding)
        for b, tree in enumerate(trees)])
