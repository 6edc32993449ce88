"""The program's proofs as plain data for the reference: python ints,
tuples and lists only, read from the proof objects' fields."""

from __future__ import annotations


def ints(xs) -> list[int]:
    return [int(x) for x in xs]


def digests(rows) -> list[tuple]:
    return [tuple(int(x) for x in row) for row in rows]


def ext(values) -> list[tuple]:
    return [tuple(int(x) for x in v) for v in values]


def fri_proof(p) -> dict:
    return {
        "commit_caps": [digests(cap) for cap in p.commit_phase_merkle_caps],
        "final_poly": ext(p.final_poly),
        "pow_witness": int(p.pow_witness),
        "queries": [{
            "initial": [[ints(leaf), digests(path)] for leaf, path
                        in q.initial_trees_proof.evals_proofs],
            "steps": [[ext(s.evals), digests(s.merkle_proof)]
                      for s in q.steps],
        } for q in p.query_round_proofs],
    }
