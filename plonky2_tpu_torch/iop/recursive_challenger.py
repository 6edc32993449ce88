"""RecursiveChallenger — the Fiat-Shamir transcript inside a circuit.

Reference: plonky2/src/iop/challenger.rs:165-280 (RecursiveChallenger),
bit-exact dual of iop/challenger.py: observe buffers targets, duplexing
overwrites the first len(inputs) state elements and permutes via PoseidonGate.
"""

from __future__ import annotations

from ..hash.sponge import NUM_HASH_OUT_ELTS, SPONGE_RATE
from ..hash.sponge import W as SPONGE_WIDTH
from ..iop.target import ExtTarget


class RecursiveChallenger:
    def __init__(self, builder):
        self.b = builder
        zero = builder.zero()
        self.sponge_state = [zero] * SPONGE_WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    def observe_element(self, t) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplexing()

    def observe_elements(self, ts) -> None:
        for t in ts:
            self.observe_element(t)

    def observe_extension_element(self, t: ExtTarget) -> None:
        self.observe_elements(list(t))

    def observe_extension_elements(self, ts) -> None:
        for t in ts:
            self.observe_extension_element(t)

    def observe_hash(self, h) -> None:
        self.observe_elements(h)

    def observe_cap(self, cap) -> None:
        for h in cap:
            self.observe_hash(h)

    def get_challenge(self):
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self):
        return self.get_n_challenges(NUM_HASH_OUT_ELTS)

    def get_extension_challenge(self) -> ExtTarget:
        c = self.get_n_challenges(2)
        return ExtTarget(c[0], c[1])

    def _duplexing(self) -> None:
        assert len(self.input_buffer) <= SPONGE_RATE
        state = list(self.sponge_state)
        for i, t in enumerate(self.input_buffer):
            state[i] = t
        self.input_buffer.clear()
        self.sponge_state = self.b.permute(state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])
