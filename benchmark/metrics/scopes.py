"""Readers of the prover's TimingTree scopes, per proof: each call's
scopes are summed by label, divided by the proofs of the call, and
averaged over the calls of the traced window."""

from __future__ import annotations

import re


def per_proof_ms(ctx, labels: str, needs: str) -> float | None:
    """Mean milliseconds a proof in the scopes whose labels match `labels`
    (a regular expression matched whole), over the calls whose scopes
    include one matching `needs`; None when no call has both."""
    values = []
    for scopes in ctx.scopes:
        if not any(re.fullmatch(needs, label) for label in scopes):
            continue
        seconds = [s for label, s in scopes.items()
                   if re.fullmatch(labels, label)]
        if seconds:
            values.append(1e3 * sum(seconds) / ctx.proofs_per_call)
    return sum(values) / len(values) if values else None
