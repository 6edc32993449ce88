"""Targets — symbolic wire/virtual value handles used by the circuit builder.

Reference: plonky2/src/iop/target.rs:24 (Target = Wire | VirtualTarget),
wire.rs:11. Represented as plain tuples for speed and hashability in
host-side circuit construction:
    ("w", row, column)   — a wire in the gate matrix
    ("v", index)         — a virtual (routable, matrix-free) target
"""

from __future__ import annotations


def wire(row: int, column: int):
    return ("w", row, column)


def virtual(index: int):
    return ("v", index)


def target_index(t, num_wires: int, degree: int) -> int:
    """Flat index into the union-find forest
    (reference: target.rs index: wires row-major, then virtuals)."""
    if t[0] == "w":
        return t[1] * num_wires + t[2]
    return degree * num_wires + t[1]
