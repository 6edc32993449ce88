"""logUp lookup argument for STARKs (https://ia.cr/2022/1530).

Reference: starky/src/lookup.rs — Column/Filter descriptors (:37-398),
Lookup (:413-440), grand-product challenges (:443-556),
lookup_helper_columns (:571-655), eval_helper_columns (:658-720),
eval_packed_lookups_generic (:875-940).

The helper columns are computed over the whole trace at once: column linear
combinations are field ops on int64 tensors, the inverses one Fermat power
over every row (filtered rows invert a dummy 1), and the running-sum Z an
exact prefix sum (`goldilocks.prefix_sum`, the reference's serial
`z.push(z[i] + x)` loop, lookup.rs:641-648).

Constraint evaluation is algebra-generic like the gates: the same code runs
over field tensors (prover quotient pass), python-int ext2 scalars
(verifier at zeta), and extension targets (recursive verifier).
"""

from __future__ import annotations

import dataclasses

import torch

from ..field import goldilocks as gl
from ..field import reference as ref


@dataclasses.dataclass(frozen=True)
class Column:
    """Linear combination of trace columns on the current (and optionally
    next) row (reference: lookup.rs:127-398)."""

    lc: tuple = ()          # ((column, coeff), ...)
    next_lc: tuple = ()     # next-row terms
    const: int = 0

    @staticmethod
    def single(c: int) -> "Column":
        return Column(lc=((c, 1),))

    @staticmethod
    def singles(cs) -> list:
        return [Column.single(c) for c in cs]

    @staticmethod
    def single_next_row(c: int) -> "Column":
        return Column(next_lc=((c, 1),))

    @staticmethod
    def constant(k: int) -> "Column":
        return Column(const=k % ref.ORDER)

    @staticmethod
    def zero() -> "Column":
        return Column()

    @staticmethod
    def one() -> "Column":
        return Column(const=1)

    @staticmethod
    def linear_combination(pairs) -> "Column":
        return Column(lc=tuple((c, f % ref.ORDER) for c, f in pairs))

    @staticmethod
    def linear_combination_with_constant(pairs, k: int) -> "Column":
        return Column(lc=tuple((c, f % ref.ORDER) for c, f in pairs),
                      const=k % ref.ORDER)

    @staticmethod
    def le_bits(cs) -> "Column":
        return Column.linear_combination(
            (c, 1 << i) for i, c in enumerate(cs))

    @staticmethod
    def le_bytes(cs) -> "Column":
        return Column.linear_combination(
            (c, 1 << (8 * i)) for i, c in enumerate(cs))

    @staticmethod
    def sum_of(cs) -> "Column":
        return Column.linear_combination((c, 1) for c in cs)

    # -- evaluation -----------------------------------------------------------
    def eval(self, alg, local):
        acc = alg.const(self.const)
        for c, f in self.lc:
            acc = alg.add(acc, alg.mul_const(local[c], f))
        return acc

    def eval_with_next(self, alg, local, next_values):
        acc = self.eval(alg, local)
        for c, f in self.next_lc:
            acc = alg.add(acc, alg.mul_const(next_values[c], f))
        return acc

    def eval_table(self, trace: torch.Tensor) -> torch.Tensor:
        """Evaluation on every row of a [cols, n] trace. The next row of the
        last row is treated as zero (reference: lookup.rs:322-334)."""
        n = trace.shape[-1]
        acc = gl.const(self.const, trace.device, (n,))
        for c, f in self.lc:
            acc = gl.add(acc, gl.mul_const(trace[c], f))
        if self.next_lc:
            last = torch.arange(n, device=trace.device) == n - 1
            for c, f in self.next_lc:
                term = gl.mul_const(torch.roll(trace[c], -1), f)
                acc = gl.add(acc, term.masked_fill(last, 0))
        return acc


@dataclasses.dataclass(frozen=True)
class Filter:
    """sum of pairwise column products plus single columns
    (reference: lookup.rs:37-120)."""

    products: tuple = ()
    constants: tuple = ()

    @staticmethod
    def new_simple(col: Column) -> "Filter":
        return Filter(constants=(col,))

    def eval_filter(self, alg, local, next_values):
        acc = alg.zero()
        for c1, c2 in self.products:
            acc = alg.add(acc, alg.mul(c1.eval_with_next(alg, local, next_values),
                                       c2.eval_with_next(alg, local, next_values)))
        for col in self.constants:
            acc = alg.add(acc, col.eval_with_next(alg, local, next_values))
        return acc

    def eval_table(self, trace: torch.Tensor) -> torch.Tensor:
        n = trace.shape[-1]
        acc = torch.zeros(n, dtype=torch.int64, device=trace.device)
        for c1, c2 in self.products:
            acc = gl.add(acc, gl.mul(c1.eval_table(trace),
                                     c2.eval_table(trace)))
        for col in self.constants:
            acc = gl.add(acc, col.eval_table(trace))
        return acc


@dataclasses.dataclass(frozen=True)
class Lookup:
    """columns ⊆ table_column with multiplicities frequencies_column
    (reference: lookup.rs:413-440)."""

    columns: tuple
    table_column: Column
    frequencies_column: Column
    filter_columns: tuple = ()   # Optional[Filter] per looking column

    def __post_init__(self):
        if not self.filter_columns:
            object.__setattr__(self, "filter_columns",
                               tuple(None for _ in self.columns))

    def num_helper_columns(self, constraint_degree: int) -> int:
        chunk = max(constraint_degree - 1, 1)
        return -(-len(self.columns) // chunk) + 1


def get_grand_product_challenge_set(challenger, num_challenges: int):
    """Draw (beta, gamma) pairs; lookups use the betas
    (reference: lookup.rs:522-552, prover.rs:131-141)."""
    challenges = []
    for _ in range(num_challenges):
        beta = challenger.get_challenge()
        gamma = challenger.get_challenge()
        challenges.append((beta, gamma))
    return challenges


def cumsum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """[0, x0, x0+x1, ...] over the last axis."""
    z = gl.prefix_sum(x)
    return torch.cat([torch.zeros_like(z[..., :1]), z[..., :-1]], dim=-1)


def filtered_inverse(combined: torch.Tensor, filt, trace: torch.Tensor):
    """1 / combined on rows whose filter is nonzero, 0 on the others (which
    invert a dummy 1: zero cannot be inverted)."""
    if filt is None:
        return gl.inverse(combined)
    on = filt.eval_table(trace) != 0
    inv = gl.inverse(torch.where(on, combined, torch.ones_like(combined)))
    return inv.masked_fill(~on, 0)


def lookup_helper_columns(lookup: Lookup, trace: torch.Tensor,
                          challenge: int,
                          constraint_degree: int) -> torch.Tensor:
    """The logUp helper columns h_i, plus the running-sum Z, for one
    challenge, as int64 [num_helper_columns, n] on the trace's device
    (reference: lookup.rs:571-655)."""
    chunk_size = max(constraint_degree - 1, 1)
    cols = list(lookup.columns)
    filters = list(lookup.filter_columns)

    helpers = []
    for start in range(0, len(cols), chunk_size):
        acc = None
        for col, filt in zip(cols[start:start + chunk_size],
                             filters[start:start + chunk_size]):
            combined = gl.add_const(col.eval_table(trace), challenge)
            inv = filtered_inverse(combined, filt, trace)
            acc = inv if acc is None else gl.add(acc, inv)
        helpers.append(acc)

    table_inv = gl.inverse(gl.add_const(
        lookup.table_column.eval_table(trace), challenge))
    freq = lookup.frequencies_column.eval_table(trace)
    x = helpers[0]
    for h in helpers[1:]:
        x = gl.add(x, h)
    x = gl.sub(x, gl.mul(freq, table_inv))
    z = cumsum_exclusive(x)
    return torch.stack(helpers + [z])


def eval_lookups(alg, stark, lookups, local_values, next_values,
                 lookup_local, lookup_next, challenges, consumer) -> None:
    """Lookup constraints, algebra-generic; `challenges` are algebra elements
    (reference: lookup.rs eval_packed_lookups_generic:875-940 +
    eval_helper_columns:658-720)."""
    degree = stark.constraint_degree()
    chunk_size = max(degree - 1, 1)
    start = 0
    for lookup in lookups:
        nh = lookup.num_helper_columns(degree)
        for challenge in challenges:
            cols = list(lookup.columns)
            filts = list(lookup.filter_columns)
            hs = lookup_local[start:start + nh - 1]
            for k, cstart in enumerate(range(0, len(cols), chunk_size)):
                chunk = cols[cstart:cstart + chunk_size]
                fs = filts[cstart:cstart + chunk_size]
                h = hs[k]
                combins = [alg.add(c.eval_with_next(
                    alg, local_values, next_values), challenge)
                    for c in chunk]
                fvals = [f.eval_filter(alg, local_values, next_values)
                         if f is not None else alg.const(1) for f in fs]
                if len(chunk) == 2:
                    # h*(x+f0)(x+f1) = filt0*(x+f1) + filt1*(x+f0)
                    consumer.constraint(alg.sub(
                        alg.mul(alg.mul(combins[1], combins[0]), h),
                        alg.add(alg.mul(fvals[0], combins[1]),
                                alg.mul(fvals[1], combins[0]))))
                elif len(chunk) == 1:
                    consumer.constraint(alg.sub(alg.mul(combins[0], h),
                                                fvals[0]))
                else:
                    raise NotImplementedError(
                        "lookup chunks of size > 2 not supported")
            # Z polynomial: Z(gx) = Z(x) + sum h_i - m*g  (multiplied through
            # by (table + challenge))
            z = lookup_local[start + nh - 1]
            next_z = lookup_next[start + nh - 1]
            table = alg.add(
                lookup.table_column.eval(alg, local_values), challenge)
            y = alg.zero()
            for h in hs:
                y = alg.add(y, h)
            y = alg.sub(alg.mul(y, table),
                        lookup.frequencies_column.eval(alg, local_values))
            consumer.constraint_first_row(z)
            consumer.constraint(alg.sub(alg.mul(alg.sub(next_z, z), table), y))
            start += nh
