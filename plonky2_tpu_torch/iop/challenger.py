"""Fiat-Shamir challenger: the duplex sponge over the hasher's host
permutation (reference: plonky2/src/iop/challenger.rs — observe
buffers inputs and duplexes at RATE; get_challenge pops from the END of the
squeezed outputs; duplexing overwrites state[0:len(inputs)])."""

from __future__ import annotations

from ..field import reference as ref
from ..hash.hashers import digest_to_elements
from ..hash.sponge import SPONGE_RATE, W


class Challenger:
    def __init__(self, hasher):
        self.hasher = hasher
        self.sponge_state: list[int] = [0] * W
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def __deepcopy__(self, memo) -> "Challenger":
        """A fork of the transcript: the sponge and buffers are copied, the
        hasher (stateless) is shared."""
        fork = Challenger(self.hasher)
        fork.sponge_state = list(self.sponge_state)
        fork.input_buffer = list(self.input_buffer)
        fork.output_buffer = list(self.output_buffer)
        return fork

    def observe_element(self, x: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(x) % ref.ORDER)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplexing()

    def observe_elements(self, xs) -> None:
        for x in xs:
            self.observe_element(int(x))

    def observe_extension_element(self, x) -> None:
        self.observe_elements(x)

    def observe_extension_elements(self, xs) -> None:
        for x in xs:
            self.observe_extension_element(x)

    def observe_hash(self, h) -> None:
        """A digest as its field elements (GenericHashOut::to_vec: a byte
        digest as 7-byte LE chunks; reference: hash_types.rs:109,182-192)."""
        self.observe_elements(digest_to_elements(h))

    def observe_cap(self, cap) -> None:
        for h in cap:
            self.observe_hash(h)

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple[int, int]:
        c = self.get_n_challenges(2)
        return (c[0], c[1])

    def get_n_extension_challenges(self, n: int) -> list[tuple[int, int]]:
        return [self.get_extension_challenge() for _ in range(n)]

    def compact(self) -> list[int]:
        """Flush pending inputs and return the sponge state (reference:
        challenger.rs:147-153)."""
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.sponge_state)

    def _duplexing(self) -> None:
        assert len(self.input_buffer) <= SPONGE_RATE
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = self.hasher.permute_oracle(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])
