"""Cross-table lookups: multi-STARK systems share values between tables.

Reference: starky/src/cross_table_lookup.rs — TableWithColumns (:67-83),
CrossTableLookup (:87-141), CtlData/CtlZData (:146-225), get_ctl_data (:226),
cross_table_lookup_data (:317-390), partial_sums (:425-466),
CtlCheckVars::from_proofs (:494-620), eval_cross_table_lookup_checks
(:622-712), verify_cross_table_lookups (:946-995), debug check_ctls (:1061).

The argument: for each CTL and challenge, every participating table carries a
running-sum Z column over `filter/(challenge + combine(columns))`; the grand
sums of all looking tables must equal the looked table's. Z columns are
"upside down" (complete sum on row 0) so the transition constraint reads the
local row only.

The helper columns and Z running sums are computed over the whole trace as
the logUp lookups' are (lookup.py): int64 field tensors, one Fermat inverse
over every row, and an exact suffix sum (`goldilocks.suffix_sum`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field import reference as ref
from .lookup import Filter, filtered_inverse, get_grand_product_challenge_set


@dataclasses.dataclass(frozen=True)
class TableWithColumns:
    """A table index + column linear combinations + row filter
    (reference: cross_table_lookup.rs:67-83)."""
    table: int
    columns: tuple
    filter: Filter | None = None


@dataclasses.dataclass(frozen=True)
class CrossTableLookup:
    """looking_tables' filtered rows, concatenated, must be a permutation of
    looked_table's (reference: cross_table_lookup.rs:87-113)."""
    looking_tables: tuple
    looked_table: TableWithColumns

    def __post_init__(self):
        assert all(len(t.columns) == len(self.looked_table.columns)
                   for t in self.looking_tables)


@dataclasses.dataclass
class CtlZData:
    """Aux data for one Z polynomial on one table
    (reference: cross_table_lookup.rs:155-195)."""
    helper_columns: torch.Tensor | None     # [h, n] or None
    z: torch.Tensor                          # [n]
    challenge: int
    columns: list                  # list of tuple[Column]
    filter: list                   # list of Filter|None


@dataclasses.dataclass
class CtlData:
    zs_columns: list = dataclasses.field(default_factory=list)

    def num_ctl_helper_polys(self) -> list[int]:
        return [0 if z.helper_columns is None else z.helper_columns.shape[0]
                for z in self.zs_columns]

    def auxiliary_polys(self) -> torch.Tensor | None:
        """All helper columns then all Z columns, the oracle layout
        (reference: get_ctl_auxiliary_polys, cross_table_lookup.rs:305-315)."""
        if not self.zs_columns:
            return None
        parts = [z.helper_columns for z in self.zs_columns
                 if z.helper_columns is not None]
        parts += [z.z.reshape(1, -1) for z in self.zs_columns]
        return torch.cat(parts)


def num_ctl_helpers_zs_all(ctls, table: int, num_challenges: int,
                           constraint_degree: int):
    """(total helpers, total zs, helpers per ctl) for `table`
    (reference: cross_table_lookup.rs:114-141)."""
    num_helpers = 0
    num_ctls = 0
    num_helpers_by_ctl = [0] * len(ctls)
    for i, ctl in enumerate(ctls):
        appearances = sum(1 for t in [ctl.looked_table, *ctl.looking_tables]
                          if t.table == table)
        if appearances > 1:
            num_helpers_by_ctl[i] = -(-appearances // (constraint_degree - 1))
            num_helpers += num_helpers_by_ctl[i]
        if appearances > 0:
            num_ctls += 1
    return num_helpers * num_challenges, num_ctls * num_challenges, \
        num_helpers_by_ctl


def partial_sums(trace: torch.Tensor, columns_filters, beta: int,
                 gamma: int, constraint_degree: int) -> torch.Tensor:
    """Helper columns + upside-down Z for one table
    (reference: cross_table_lookup.rs:425-466). Returns int64 [h(+1), n]."""
    chunk_size = max(constraint_degree - 1, 1)

    def combine(cols) -> torch.Tensor:
        # sum_i eval_i * beta^i + gamma (reference: lookup.rs:454-476)
        acc = torch.zeros_like(trace[0])
        for col in reversed(cols):
            acc = gl.add(gl.mul_const(acc, beta), col.eval_table(trace))
        return gl.add_const(acc, gamma)

    helpers = []
    cfs = list(columns_filters)
    for start in range(0, len(cfs), chunk_size):
        acc = None
        for cols, filt in cfs[start:start + chunk_size]:
            inv = filtered_inverse(combine(cols), filt, trace)
            acc = inv if acc is None else gl.add(acc, inv)
        helpers.append(acc)

    x = helpers[0]
    for h in helpers[1:]:
        x = gl.add(x, h)
    z = gl.suffix_sum(x)
    if len(cfs) > 1:
        return torch.stack(helpers + [z])
    return z.reshape(1, -1)


def get_ctl_data(config, trace_per_table: list, ctls,
                 challenger, max_constraint_degree: int):
    """Draw CTL challenges and compute all tables' CtlData
    (reference: cross_table_lookup.rs:226-252, 317-390)."""
    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    n_tables = len(trace_per_table)
    ctl_data_per_table = [CtlData() for _ in range(n_tables)]
    for ctl in ctls:
        for beta, gamma in ctl_challenges:
            # group looking tables by table index, preserving first-seen order
            order = []
            for t in ctl.looking_tables:
                if t.table not in order:
                    order.append(t.table)
            for table in order:
                group = [t for t in ctl.looking_tables if t.table == table]
                cfs = [(t.columns, t.filter) for t in group]
                hz = partial_sums(trace_per_table[table], cfs, beta, gamma,
                                  max_constraint_degree)
                nh = hz.shape[0] - 1
                ctl_data_per_table[table].zs_columns.append(CtlZData(
                    helper_columns=hz[:nh] if nh > 0 else None,
                    z=hz[nh],
                    challenge=(beta, gamma),
                    columns=[t.columns for t in group],
                    filter=[t.filter for t in group]))
            looked = ctl.looked_table
            hz = partial_sums(trace_per_table[looked.table],
                              [(looked.columns, looked.filter)], beta, gamma,
                              max_constraint_degree)
            ctl_data_per_table[looked.table].zs_columns.append(CtlZData(
                helper_columns=None,
                z=hz[0],
                challenge=(beta, gamma),
                columns=[looked.columns],
                filter=[looked.filter]))
    return ctl_challenges, ctl_data_per_table


@dataclasses.dataclass
class CtlCheckVars:
    """Openings-side data to check one Z polynomial
    (reference: cross_table_lookup.rs:469-620; single-table extraction
    mirrors CtlCheckVarsTarget::from_proof :734-840)."""
    helper_columns: list
    local_z: object
    next_z: object
    challenge: tuple        # (beta, gamma) as algebra elements
    columns: list
    filter: list


def num_ctl_counts(ctls, table: int, constraint_degree: int):
    """Per-ctl helper counts for `table` (reference:
    num_ctl_helper_columns_by_table, cross_table_lookup.rs:277-303)."""
    counts = []
    for ctl in ctls:
        appearances = sum(1 for t in ctl.looking_tables if t.table == table)
        counts.append(-(-appearances // max(constraint_degree - 1, 1))
                      if appearances > 1 else 0)
    return counts


def ctl_check_vars_single(table: int, ctl_zs, ctls, challenges,
                          num_helper_ctl: list[int]):
    """Build CtlCheckVars for one table from its aux-column pairs.

    ctl_zs: list of (local, next) algebra elements — the table's aux columns
    AFTER the logUp lookup columns (helpers first, then z columns).
    challenges: list of (beta, gamma) algebra elements.
    num_helper_ctl: per-ctl helper count for this table."""
    total_helpers = sum(num_helper_ctl) * len(challenges)
    z_index = 0
    start_index = 0
    ctl_vars = []
    for ctl, nh in zip(ctls, num_helper_ctl):
        for challenge in challenges:
            group = [t for t in ctl.looking_tables if t.table == table]
            if group:
                looking_z, looking_z_next = ctl_zs[total_helpers + z_index]
                helpers = [h for h, _ in
                           ctl_zs[start_index:start_index + nh]]
                start_index += nh
                z_index += 1
                ctl_vars.append(CtlCheckVars(
                    helper_columns=helpers,
                    local_z=looking_z, next_z=looking_z_next,
                    challenge=challenge,
                    columns=[t.columns for t in group],
                    filter=[t.filter for t in group]))
            if ctl.looked_table.table == table:
                looked = ctl.looked_table
                looked_z, looked_z_next = ctl_zs[total_helpers + z_index]
                z_index += 1
                ctl_vars.append(CtlCheckVars(
                    helper_columns=[],
                    local_z=looked_z, next_z=looked_z_next,
                    challenge=challenge,
                    columns=[looked.columns], filter=[looked.filter]))
    return ctl_vars


def eval_cross_table_lookup_checks(alg, local_values, next_values, ctl_vars,
                                   consumer, constraint_degree: int) -> None:
    """CTL constraints, algebra-generic; challenge components are passed as
    algebra elements via each CtlCheckVars (converted by the caller)
    (reference: cross_table_lookup.rs:622-712)."""
    chunk_size = max(constraint_degree - 1, 1)
    for lv in ctl_vars:
        beta, gamma = lv.challenge

        def combine(cols):
            acc = alg.zero()
            for col in reversed(list(cols)):
                acc = alg.add(alg.mul(acc, beta),
                              col.eval_with_next(alg, local_values,
                                                 next_values))
            return alg.add(acc, gamma)

        evals = [combine(cols) for cols in lv.columns]
        fvals = [f.eval_filter(alg, local_values, next_values)
                 if f is not None else alg.const(1) for f in lv.filter]

        # helper-column consistency (reference: eval_helper_columns)
        if lv.helper_columns:
            for k, start in enumerate(range(0, len(lv.columns), chunk_size)):
                chunk = evals[start:start + chunk_size]
                fs = fvals[start:start + chunk_size]
                h = lv.helper_columns[k]
                if len(chunk) == 2:
                    consumer.constraint(alg.sub(
                        alg.mul(alg.mul(chunk[1], chunk[0]), h),
                        alg.add(alg.mul(fs[0], chunk[1]),
                                alg.mul(fs[1], chunk[0]))))
                else:
                    consumer.constraint(alg.sub(alg.mul(chunk[0], h), fs[0]))
            h_sum = alg.zero()
            for h in lv.helper_columns:
                h_sum = alg.add(h_sum, h)
            consumer.constraint_last_row(alg.sub(lv.local_z, h_sum))
            consumer.constraint_transition(
                alg.sub(alg.sub(lv.local_z, lv.next_z), h_sum))
        elif len(lv.columns) > 1:
            c0, c1 = evals[0], evals[1]
            f0, f1 = fvals[0], fvals[1]
            both = alg.mul(c0, c1)
            rhs = alg.add(alg.mul(f0, c1), alg.mul(f1, c0))
            consumer.constraint_last_row(
                alg.sub(alg.mul(both, lv.local_z), rhs))
            consumer.constraint_transition(
                alg.sub(alg.mul(both, alg.sub(lv.local_z, lv.next_z)), rhs))
        else:
            c0, f0 = evals[0], fvals[0]
            consumer.constraint_last_row(
                alg.sub(alg.mul(c0, lv.local_z), f0))
            consumer.constraint_transition(
                alg.sub(alg.mul(c0, alg.sub(lv.local_z, lv.next_z)), f0))


def verify_cross_table_lookups(ctls, ctl_zs_first: list[list[int]],
                               num_challenges: int,
                               extra_looking_sums=None) -> None:
    """Check grand sums match across tables: openings of the Z columns at
    x=1 (first row) (reference: cross_table_lookup.rs:946-995)."""
    iters = [iter(v) for v in ctl_zs_first]
    for index, ctl in enumerate(ctls):
        order = []
        for t in ctl.looking_tables:
            if t.table not in order:
                order.append(t.table)
        for c in range(num_challenges):
            looking_sum = 0
            for table in order:
                looking_sum = ref.add(looking_sum, next(iters[table]))
            if extra_looking_sums is not None:
                looking_sum = ref.add(
                    looking_sum, extra_looking_sums[ctl.looked_table.table][c])
            looked_z = next(iters[ctl.looked_table.table])
            assert looking_sum == looked_z, \
                f"Cross-table lookup {index} verification failed"
    for it in iters:
        assert next(it, None) is None


def check_ctls(trace_per_table: list, ctls,
               extra_looking_values=None) -> None:
    """Debug multiset check on raw traces (numpy u64 or int64 field
    tensors) (reference: cross_table_lookup.rs:1061-1160)."""
    for i, ctl in enumerate(ctls):
        looking: dict = {}
        looked: dict = {}

        def process(table_wc, multiset):
            trace = trace_per_table[table_wc.table]
            if not isinstance(trace, torch.Tensor):
                trace = gl.from_u64(np.asarray(trace, dtype=np.uint64), "cpu")
            n = trace.shape[-1]
            filt = (gl.to_u64(table_wc.filter.eval_table(trace))
                    if table_wc.filter is not None else np.ones(n))
            rows = np.stack([gl.to_u64(c.eval_table(trace))
                             for c in table_wc.columns], axis=0)
            for r in range(n):
                if filt[r] == 1:
                    key = tuple(int(x) for x in rows[:, r])
                    multiset.setdefault(key, []).append((table_wc.table, r))
                else:
                    assert filt[r] == 0, "Non-binary filter?"

        for t in ctl.looking_tables:
            process(t, looking)
        process(ctl.looked_table, looked)
        if extra_looking_values and i in extra_looking_values:
            for row in extra_looking_values[i]:
                looking.setdefault(tuple(row), []).append((0, 0))
        for row in set(looking) | set(looked):
            a = len(looking.get(row, []))
            b = len(looked.get(row, []))
            assert a == b, (f"CTL #{i}: row {row} appears {a} times looking "
                            f"vs {b} times looked")
