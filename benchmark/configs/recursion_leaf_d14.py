"""recursion_leaf_d14 on the program: plonky2's dummy circuit built by the
port's CircuitBuilder and proved by `CircuitData.prove` (one proof a call)
or `batch_prover.prove_batch` (several)."""

from __future__ import annotations

from benchmark import plain


def draw(rng, cfg: dict) -> list[int]:
    """One request: the circuit's public inputs, uniform field elements."""
    p = (1 << 64) - (1 << 32) + 1
    return [int(x) for x in rng.integers(0, p, cfg["num_public_inputs"],
                                         dtype="uint64")]


def circuit_config(cfg: dict):
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    fri = cfg["fri"]
    return CircuitConfig(
        num_wires=cfg["num_wires"],
        num_routed_wires=cfg["num_routed_wires"],
        num_constants=cfg["num_constants"],
        num_challenges=cfg["num_challenges"],
        zero_knowledge=cfg["zero_knowledge"],
        max_quotient_degree_factor=cfg["max_quotient_degree_factor"],
        fri_config=FriConfig(
            rate_bits=fri["rate_bits"], cap_height=fri["cap_height"],
            proof_of_work_bits=fri["proof_of_work_bits"],
            reduction_strategy=FriReductionStrategy(
                kind="constant_arity", arity_bits=fri["arity_bits"],
                final_poly_bits=fri["final_poly_bits"]),
            num_query_rounds=fri["num_query_rounds"]))


class System:
    """The circuit, built once from the configuration; the builder's random
    stream (the unused public-input-gate wires) is seeded from the run's
    seed."""

    def __init__(self, cfg: dict, device, seed: int):
        from plonky2_tpu_torch.hash.hashers import CONFIGS
        from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
        builder = CircuitBuilder(circuit_config(cfg), seed=seed)
        self.pi_targets = builder.add_virtual_targets(
            cfg["num_public_inputs"])
        builder.register_public_inputs(self.pi_targets)
        self.data = builder.build(device=device,
                                  min_degree_bits=cfg["degree_bits"],
                                  gc=CONFIGS[cfg["hasher"]])

    def prepare(self, inputs: list) -> list:
        from plonky2_tpu_torch.iop.witness import PartialWitness
        witnesses = []
        for pis in inputs:
            pw = PartialWitness()
            pw.set_targets(zip(self.pi_targets, pis))
            witnesses.append(pw)
        return witnesses

    def prove(self, witnesses: list, timing) -> list:
        if len(witnesses) == 1:
            return [self.data.prove(witnesses[0], timing=timing)]
        from plonky2_tpu_torch.plonk.batch_prover import prove_batch
        return prove_batch(self.data.prover_only, self.data.common,
                           witnesses, timing=timing)

    @staticmethod
    def plain(proof) -> dict:
        p = proof.proof
        o = p.openings
        return {
            "public_inputs": plain.ints(proof.public_inputs),
            "caps": [plain.digests(c) for c in (
                p.wires_cap, p.plonk_zs_partial_products_cap,
                p.quotient_polys_cap)],
            "openings": {name: plain.ext(getattr(o, name)) for name in (
                "constants", "plonk_sigmas", "wires", "plonk_zs",
                "plonk_zs_next", "partial_products", "quotient_polys")},
            "fri": plain.fri_proof(p.opening_proof),
        }

    def close(self) -> None:
        self.data = None
