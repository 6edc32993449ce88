"""PolynomialBatch — the FRI commitment without salt (reference
fri/oracle.rs from_values:62, from_coeffs:134, get_lde_values:474,
prove_openings:508 with the final-poly-times-X tweak at :547).

A commit is: iNTT (from values), coset LDE at rate 2^rate_bits (K1), then
the Merkle tree over the LDE rows in bit-reversed order (the leaves). A
device hasher hashes the leaf digests straight off the [num, N] LDE columns
in natural order (K3 or K7), then bit-reverses them into leaf order, and
builds the layers above them (the tree entry of K2 or K6); a host hasher
(Keccak, PoseidonBN128) hashes the host copy of the leaves (`MerkleTree`).
"""

from __future__ import annotations

import torch

from ..field import reference as ref
from ..field.extension import GF2
from ..hash.merkle import MerkleTree
from ..iop.challenger import Challenger
from ..ops import ntt
from ..ops.polynomial import divide_by_linear, reduce_polys_base
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .prover import fri_proof
from .structure import FriInstanceInfo


class PolynomialBatch:
    """polynomials: int64 [num_polys, 2^degree_log] coefficient rows."""

    def __init__(self, polynomials: torch.Tensor, merkle_tree: MerkleTree,
                 degree_log: int, rate_bits: int):
        self.polynomials = polynomials
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits

    @staticmethod
    def from_values(values: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher) -> "PolynomialBatch":
        return PolynomialBatch.from_coeffs(ntt.ifft(values), rate_bits,
                                           cap_height, hasher)

    @staticmethod
    def from_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher) -> "PolynomialBatch":
        lg_n = log2_strict(coeffs.shape[-1])
        lde = ntt.coset_lde(coeffs, rate_bits)                  # [num, N]
        rev = ntt._perm("rev", lde.shape[-1], lde.device)
        leaves = lde.t().index_select(0, rev)                   # [N, num]
        digests = (hasher.hash_or_noop_columns(lde).index_select(0, rev)
                   if hasher.device else None)
        tree = MerkleTree(leaves, cap_height, hasher, leaf_digests=digests)
        return PolynomialBatch(coeffs, tree, lg_n, rate_bits)

    @property
    def lde_bits(self) -> int:
        return self.degree_log + self.rate_bits

    def natural_lde(self, step: int) -> torch.Tensor:
        """[num_polys, N / step] LDE values in natural point order."""
        leaves = self.merkle_tree.leaves
        rev = ntt._perm("rev", leaves.shape[0], leaves.device)
        return leaves.index_select(0, rev[::step]).t()

    def get_lde_values(self, index: int, step: int = 1):
        """Host row of LDE values at point index * step."""
        return self.merkle_tree.leaves_host()[
            reverse_bits(index * step, self.lde_bits)]

    def get_lde_values_batch(self, indices, step: int = 1):
        """[k, num_polys] host rows for many points."""
        return self.merkle_tree.rows_batch(
            [reverse_bits(int(i) * step, self.lde_bits) for i in indices])

    @staticmethod
    def prove_openings(instance: FriInstanceInfo, oracles: list,
                       challenger: Challenger, fri_params: FriParams):
        alpha = challenger.get_extension_challenge()
        n = oracles[0].polynomials.shape[-1]
        device = oracles[0].polynomials.device
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
        shifted = GF2.cat([GF2.zeros((1,), device), final[:n - 1]])
        rate_bits = fri_params.config.rate_bits
        pad = GF2.zeros((n * ((1 << rate_bits) - 1),), device)
        lde_coeffs = GF2.cat([shifted, pad])
        lde_values = ntt.coset_lde_ext(shifted, rate_bits)
        return fri_proof([o.merkle_tree for o in oracles], lde_coeffs,
                         lde_values, challenger, fri_params)
