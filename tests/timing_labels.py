"""The port's TimingTree labels as the provers open them (plonk/prover.py,
starky/prover.py, fri/oracle.py, fri/prover.py, plonk/vanishing.py), for
the tests that hold a tree's scopes: the depth-0 labels in order, and for
each scope that has scopes inside it, their labels in order."""

from plonky2_tpu_torch.plonk.prover import HOST_SPANS

UPLOAD, CHALLENGES, ASSEMBLY = HOST_SPANS
FRI_INSIDE = (CHALLENGES, "reduce batch of polynomials", "perform final FFT",
              "fold codewords in the commitment phase",
              "find proof-of-work witness", "FRI query rounds")
# the witness fixpoint's spans (iop/generator.py), once a proof
FIXPOINT = ("generator index", "generator passes")
# the wire matrix built and uploaded, inside the witness upload, once a call
WIRE_MATRIX = "wire matrix"
# a commit's Merkle trees (fri/oracle.py, hash/merkle.py), inside each
# commitment scope and before each FRI fold's cap
MERKLE = "merkle trees"
STARK_TOP = ("trace to device", "compute trace commitment", CHALLENGES,
             CHALLENGES, "compute quotient polys",
             "compute quotient commitment", CHALLENGES, "openings",
             CHALLENGES, "FRI opening proof", ASSEMBLY)


def top(tree) -> list:
    """The depth-0 labels, in order."""
    return [label for depth, label, _ in tree.records if depth == 0]


def nested(tree) -> list:
    """(label, [labels of the scopes directly inside it]) of each scope
    that has any, in the order the scopes opened."""
    spans = sorted(tree.spans, key=lambda s: (s.start_ns, s.id))
    inside: dict = {}
    for s in spans:
        if s.parent is not None:
            inside.setdefault(s.parent, []).append(s.label)
    return [(s.label, inside[s.id]) for s in spans if s.id in inside]


def plonk_top(scopes, B: int) -> list:
    """`prove_many`'s depth-0 labels for B proofs under `scopes`
    (SERIAL_SCOPES or BATCH_SCOPES): JAX's eight in JAX's order, with the
    HOST_SPANS between them."""
    s = scopes
    return ([s[0], UPLOAD, s[1], CHALLENGES, s[2], s[3], CHALLENGES, s[4],
             s[5], CHALLENGES, s[6]]
            + [label for b in range(B)
               for label in (CHALLENGES, s[7].format(b=b), ASSEMBLY)])


def _fri(label: str, folds: int) -> list:
    return [(label, list(FRI_INSIDE))] + (
        [(FRI_INSIDE[3], [MERKLE, CHALLENGES] * folds)] if folds else [])


def plonk_nested(common, scopes, B: int) -> list:
    """`nested` of a prove_many of B proofs whose round 3 is one pass."""
    gates = [f"gate {g.id()}" for g in common.gates if g.num_constraints()]
    folds = len(common.fri_params.reduction_arity_bits)
    return ([(scopes[0], list(FIXPOINT) * B),
             (UPLOAD, [WIRE_MATRIX]),
             (scopes[1], [MERKLE]),
             (scopes[3], [MERKLE]),
             (scopes[4], ["coset values", "gate constraints",
                          "permutation terms", "alpha reduction",
                          "quotient iNTT"]),
             ("gate constraints", gates),
             (scopes[5], [MERKLE])]
            + [item for b in range(B)
               for item in _fri(scopes[7].format(b=b), folds)])


def stark_nested(fri_params) -> list:
    """`nested` of a STARK prove without lookups."""
    return ([("compute trace commitment", [MERKLE]),
             ("compute quotient polys", ["coset values",
                                         "evaluate constraints",
                                         "quotient iNTT"]),
             ("compute quotient commitment", [MERKLE])]
            + _fri("FRI opening proof", len(fri_params.reduction_arity_bits)))


def labels(top_labels, nested_labels) -> set:
    return set(top_labels) | {label for _, inner in nested_labels
                              for label in inner}
