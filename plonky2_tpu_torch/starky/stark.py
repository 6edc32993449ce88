"""Stark base class + constraint consumer.

Reference: starky/src/stark.rs:24-280 (Stark trait),
constraint_consumer.rs:20-90, evaluation_frame.rs:8-50.

A Stark's `eval` is written ONCE over an abstract algebra and an
EvaluationFrame of algebra elements: the prover feeds int64 field tensors
over the whole quotient coset (`GFAlgebra`), the verifier python-int ext2
scalars at zeta (`EXT`), and the recursive verifier extension targets
(`TargetAlgebra`).
"""

from __future__ import annotations

from ..field import reference as ref
from ..fri.structure import FriBatchInfo, FriInstanceInfo, FriOracleInfo, \
    FriPolynomialInfo


class EvaluationFrame:
    """Two consecutive trace rows + public inputs, as algebra elements."""

    def __init__(self, local_values, next_values, public_inputs):
        self.local_values = local_values
        self.next_values = next_values
        self.public_inputs = public_inputs


class ConstraintConsumer:
    """Accumulates sum_k alpha^k * c_k per challenge
    (reference: constraint_consumer.rs:20-88)."""

    def __init__(self, alg, alphas, z_last, lagrange_first, lagrange_last):
        self.alg = alg
        self.alphas = alphas
        self.z_last = z_last
        self.l_first = lagrange_first
        self.l_last = lagrange_last
        self.accs = [alg.zero() for _ in alphas]

    def constraint(self, c):
        for i, a in enumerate(self.alphas):
            self.accs[i] = self.alg.add(self.alg.mul(self.accs[i], a), c)

    def constraint_transition(self, c):
        """Holds on all rows but the last."""
        self.constraint(self.alg.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(self.alg.mul(c, self.l_first))

    def constraint_last_row(self, c):
        self.constraint(self.alg.mul(c, self.l_last))


class Stark:
    """Subclass and define COLUMNS, PUBLIC_INPUTS, constraint_degree, eval."""

    COLUMNS: int = 0
    PUBLIC_INPUTS: int = 0

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def eval(self, alg, frame: EvaluationFrame,
             consumer: ConstraintConsumer) -> None:
        raise NotImplementedError

    def lookups(self) -> list:
        """logUp lookups performed across this table's columns
        (reference: stark.rs:250-258)."""
        return []

    def uses_lookups(self) -> bool:
        return len(self.lookups()) > 0

    def requires_ctls(self) -> bool:
        return False

    def num_lookup_helper_columns(self, config) -> int:
        return config.num_challenges * sum(
            lk.num_helper_columns(self.constraint_degree())
            for lk in self.lookups())

    # ------------------------------------------------------------------
    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1)

    def num_quotient_polys(self, config) -> int:
        return config.num_challenges * self.quotient_degree_factor()

    def fri_instance(self, zeta, g: int, config,
                     num_ctl_helpers: int = 0,
                     num_ctl_zs: int = 0) -> FriInstanceInfo:
        """reference: stark.rs:100-172 (aux oracle present iff lookups/CTLs)."""
        oracles = []
        trace_info = FriPolynomialInfo.from_range(0, 0, self.COLUMNS)
        oracles.append(FriOracleInfo(num_polys=self.COLUMNS, blinding=False))

        num_aux = (self.num_lookup_helper_columns(config) + num_ctl_helpers
                   + num_ctl_zs)
        aux_info = []
        if self.uses_lookups() or self.requires_ctls():
            aux_info = FriPolynomialInfo.from_range(len(oracles), 0, num_aux)
            oracles.append(FriOracleInfo(num_polys=num_aux, blinding=False))

        quotient_info = FriPolynomialInfo.from_range(
            len(oracles), 0, self.num_quotient_polys(config))
        oracles.append(FriOracleInfo(
            num_polys=self.num_quotient_polys(config), blinding=False))

        zeta_batch = FriBatchInfo(
            point=tuple(zeta),
            polynomials=tuple(trace_info + aux_info + quotient_info))
        zeta_next = ref.ext2_scalar_mul(zeta, g)
        zeta_next_batch = FriBatchInfo(point=tuple(zeta_next),
                                       polynomials=tuple(trace_info + aux_info))
        batches = [zeta_batch, zeta_next_batch]
        if self.requires_ctls():
            # CTL Z columns are also opened at x=1 (first row sums)
            num_lk = self.num_lookup_helper_columns(config)
            ctl_zs_info = FriPolynomialInfo.from_range(
                1, num_lk + num_ctl_helpers, num_aux)
            batches.append(FriBatchInfo(point=(1, 0),
                                        polynomials=tuple(ctl_zs_info)))
        return FriInstanceInfo(oracles=tuple(oracles),
                               batches=tuple(batches))
