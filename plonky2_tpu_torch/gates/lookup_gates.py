"""Lookup gates — builder-side API parity with the okx fork.

Reference: plonky2/src/gates/lookup.rs:36 (LookupGate),
lookup_table.rs:39 (LookupTableGate). NOTE: the okx fork disables the logUp
prover path (plonk/prover.rs:33-102 commented out) and does not place
LUT gates at build time (circuit_builder.rs:1056 `add_all_lookups`
commented out), so lookups are generator-driven only — the live fork
behavior reproduced here. The sound logUp argument is an upstream-parity
stretch goal (SURVEY §7 non-goals note).
"""

from __future__ import annotations

from ..field import reference as ref
from ..iop.generator import SimpleGenerator
from ..iop.target import wire
from .gate import Gate


class LookupGate(Gate):
    """Slots of (looking_in, looking_out) pairs resolved against a LUT."""

    def __init__(self, num_slots: int, lut: tuple):
        self._num_slots = num_slots
        self.lut = lut  # tuple of (input, output) pairs

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 2

    @staticmethod
    def from_config(config, lut):
        return LookupGate(LookupGate.num_slots_from_config(config), lut)

    def id(self):
        import hashlib
        h = hashlib.sha256(repr(self.lut).encode()).hexdigest()[:16]
        return f"LookupGate {{ num_slots: {self._num_slots}, lut: {h} }}"

    @staticmethod
    def wire_ith_looking_inp(i):
        return 2 * i

    @staticmethod
    def wire_ith_looking_out(i):
        return 2 * i + 1

    def num_wires(self):
        return 2 * self._num_slots

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def num_ops(self):
        return self._num_slots

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        return []

    def generators(self, row, local_constants):
        table = dict(self.lut)
        return [_LookupGenerator(row, i, table)
                for i in range(self._num_slots)]


class _LookupGenerator(SimpleGenerator):
    def __init__(self, row, slot, table):
        self.row, self.slot, self.table = row, slot, table

    def dependencies(self):
        return [wire(self.row, LookupGate.wire_ith_looking_inp(self.slot))]

    def run_once(self, witness, out):
        inp = witness.get(wire(self.row,
                               LookupGate.wire_ith_looking_inp(self.slot)))
        val = self.table.get(inp)
        if val is None:
            # The okx fork runs lookups generator-only (no logUp constraint
            # columns), so there is no constraint to reject a bad input at
            # verify time — witness generation is the enforcement point and
            # must fail loudly, never silently default.
            raise ValueError(
                f"lookup input {inp} (row {self.row} slot {self.slot}) is "
                f"outside the table domain ({len(self.table)} entries)")
        out.append((wire(self.row,
                         LookupGate.wire_ith_looking_out(self.slot)), val))


class LookupTableGate(Gate):
    """Table rows: (input, output, multiplicity) triples per slot
    (reference: lookup_table.rs; unused while the logUp prover path is
    disabled in the fork, included for API parity)."""

    def __init__(self, num_slots: int, lut: tuple, last_lut_row: int):
        self._num_slots = num_slots
        self.lut = lut
        self.last_lut_row = last_lut_row

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 3

    def id(self):
        import hashlib
        h = hashlib.sha256(repr(self.lut).encode()).hexdigest()[:16]
        return f"LookupTableGate {{ num_slots: {self._num_slots}, lut: {h} }}"

    @staticmethod
    def wire_ith_looked_inp(i):
        return 3 * i

    @staticmethod
    def wire_ith_looked_out(i):
        return 3 * i + 1

    @staticmethod
    def wire_ith_multiplicity(i):
        return 3 * i + 2

    def num_wires(self):
        return 3 * self._num_slots

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, alg, consts, wires, pi_hash):
        return []


class LookupGadgets:
    """Mixin for CircuitBuilder (reference: circuit_builder.rs add_lookup_*)."""

    def add_lookup_table_from_pairs(self, pairs) -> int:
        if not hasattr(self, "luts"):
            self.luts = []
        self.luts.append(tuple((int(a) % ref.ORDER, int(b) % ref.ORDER)
                               for a, b in pairs))
        return len(self.luts) - 1

    def add_lookup_table_from_table(self, inputs, outputs) -> int:
        return self.add_lookup_table_from_pairs(list(zip(inputs, outputs)))

    def add_lookup_table_from_fn(self, fn, inputs) -> int:
        """(reference: circuit_builder.rs add_lookup_table_from_fn)"""
        return self.add_lookup_table_from_pairs(
            [(i, fn(i)) for i in inputs])

    def add_lookup_from_index(self, looking_in, lut_index: int):
        assert hasattr(self, "luts") and lut_index < len(self.luts), \
            f"lookup table {lut_index} not registered"
        lut = self.luts[lut_index]
        gate = LookupGate(LookupGate.num_slots_from_config(self.config), lut)
        row, slot = self.find_slot(gate, (gate.id(),), [])
        self.connect(looking_in, wire(row, gate.wire_ith_looking_inp(slot)))
        return wire(row, gate.wire_ith_looking_out(slot))
