"""The check every configuration's reference makes of a run's proofs."""

from __future__ import annotations

from .fri import Refused

# what a malformed or wrong proof raises in a verifier
REFUSALS = (Refused, ValueError, TypeError, KeyError, IndexError,
            ZeroDivisionError)


def check(calls: list, sample: list, expected, verify,
          limits: dict) -> tuple[dict, list]:
    """calls: [{"inputs": [a request's inputs, one a proof], "proofs":
    [plain proof, ...]}]; sample: the calls to verify in full. `expected`
    maps a request's inputs to the public inputs its proof must carry, and
    `verify(proof, public_inputs)` raises unless the proof proves them.

    Returns ({name: (value, limit)}, reasons): `wrong_inputs`, the proofs
    of all calls that are missing or carry other public inputs than their
    request's, and `refused`, the proofs of the sampled calls that do not
    verify."""
    wrong = 0
    for call in calls:
        wrong += abs(len(call["inputs"]) - len(call["proofs"]))
        for inputs, proof in zip(call["inputs"], call["proofs"]):
            if [int(x) for x in proof["public_inputs"]] != expected(inputs):
                wrong += 1
    reasons = []
    for i in sample:
        for inputs, proof in zip(calls[i]["inputs"], calls[i]["proofs"]):
            try:
                verify(proof, expected(inputs))
            except REFUSALS as e:
                reasons.append(f"refused: call {i}: {type(e).__name__}: "
                               f"{e}")
    return {"wrong_inputs": (wrong, limits["wrong_inputs"]),
            "refused": (len(reasons), limits["refused"])}, reasons
