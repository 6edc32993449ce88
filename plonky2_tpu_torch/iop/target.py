"""Targets — symbolic wire/virtual value handles used by the circuit builder.

Reference: plonky2/src/iop/target.rs:24 (Target = Wire | VirtualTarget),
wire.rs:11, iop/ext_target.rs. Represented as plain tuples for speed and hashability in
host-side circuit construction:
    ("w", row, column)   — a wire in the gate matrix
    ("v", index)         — a virtual (routable, matrix-free) target
"""

from __future__ import annotations


def wire(row: int, column: int):
    return ("w", row, column)


def virtual(index: int):
    return ("v", index)


def is_wire(t) -> bool:
    return t[0] == "w"


def is_routable(t, num_routed_wires: int) -> bool:
    """Virtual targets are always routable; wires only if column < routed
    (reference: target.rs is_routable)."""
    return t[0] == "v" or t[2] < num_routed_wires


def target_index(t, num_wires: int, degree: int) -> int:
    """Flat index into the union-find forest
    (reference: target.rs index: wires row-major, then virtuals)."""
    if t[0] == "w":
        return t[1] * num_wires + t[2]
    return degree * num_wires + t[1]


class ExtTarget(tuple):
    """Extension target: pair (c0, c1) of base targets
    (reference: iop/ext_target.rs)."""
    __slots__ = ()

    def __new__(cls, c0, c1):
        return super().__new__(cls, (c0, c1))
