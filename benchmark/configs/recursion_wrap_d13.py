"""recursion_wrap_d13 on the program: each call proves a fresh
recursion_leaf_d14 statement through that configuration's own `System`,
then proves its recursive wrap (`recursion/verifier.py` `wrap_circuit`
with the leaf's public inputs and verifier key registered), one wrap proof
a call."""

from __future__ import annotations

from benchmark import load


def _leaf():
    return load.module("configs", "recursion_leaf_d14")


def draw(rng, cfg: dict) -> list[int]:
    """One request: the leaf's public inputs, uniform field elements."""
    return _leaf().draw(rng, cfg["inner_config"])


class System:
    """The leaf circuit, built as recursion_leaf_d14 builds it, and its
    wrap, built once under the configuration's own settings; only the
    wrap's prove runs under the call's TimingTree."""

    def __init__(self, cfg: dict, device, seed: int):
        from plonky2_tpu_torch.hash.hashers import CONFIGS
        from plonky2_tpu_torch.recursion.verifier import wrap_circuit
        leaf = _leaf()
        self.leaf = leaf.System(cfg["inner_config"], device, seed)
        builder, self.witness = wrap_circuit(
            self.leaf.data, register_inner=True,
            config=leaf.circuit_config(cfg))
        self.data = builder.build(device=device,
                                  min_degree_bits=cfg["degree_bits"],
                                  gc=CONFIGS[cfg["hasher"]])

    def prepare(self, inputs: list) -> list:
        return self.leaf.prepare(inputs)

    def prove(self, witnesses: list, timing) -> list:
        from plonky2_tpu_torch.utils.timing import TimingTree
        wraps = []
        for pw in witnesses:
            inner = self.leaf.data.prove(pw, timing=TimingTree(enabled=False))
            wraps.append(self.data.prove(self.witness(inner), timing=timing))
        return wraps

    @staticmethod
    def plain(proof) -> dict:
        return _leaf().System.plain(proof)

    def close(self) -> None:
        self.leaf.close()
        self.data = self.witness = None
