"""recursion_leaf_d14_poseidon2 on the program: recursion_leaf_d14's
circuit, requests and proofs' plain form, built by that configuration's own
`System`, which takes its GenericConfig from the configuration's `hasher`
(here Poseidon2GoldilocksConfig): the same builder calls, `CircuitData.prove`
for one proof a call."""

from __future__ import annotations

from benchmark import load

_LEAF = load.module("configs", "recursion_leaf_d14")
draw = _LEAF.draw
System = _LEAF.System
