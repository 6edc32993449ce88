"""ContextTree — hierarchical gate-count attribution for circuit debugging.

Reference: plonky2/src/util/context_tree.rs (ContextTree:134, `with_context!`)
and CircuitBuilder::push_context/pop_context (circuit_builder.rs:681-699) +
print_gate_counts (:1003-1030). The builder tags every gate-adding scope;
`report()` renders the tree with per-scope gate counts filtered by a
minimum-delta threshold — how recursion circuits get shrunk: find the scope
that owns the rows. Re-entered scopes (same name at the same depth)
accumulate.
"""

from __future__ import annotations


class ContextTree:
    def __init__(self, name: str = ""):
        self.name = name
        self.children: dict[str, "ContextTree"] = {}
        self.gate_count = 0

    def child(self, name: str) -> "ContextTree":
        if name not in self.children:
            self.children[name] = ContextTree(name)
        return self.children[name]

    def _lines(self, depth: int, min_delta: int, out: list[str]) -> None:
        if self.name and self.gate_count < min_delta:
            return
        if self.name:
            out.append(f"{'  ' * depth}{self.gate_count} gates to {self.name}")
        for c in self.children.values():
            c._lines(depth + (1 if self.name else 0), min_delta, out)

    def report(self, min_delta: int = 1) -> str:
        """Render scopes owning at least `min_delta` gate rows
        (reference: context_tree.rs filter_to_span_depth + print)."""
        out: list[str] = []
        self._lines(0, min_delta, out)
        return "\n".join(out)


class ContextStack:
    """Builder-side mutable cursor over a ContextTree."""

    def __init__(self):
        self.root = ContextTree()
        self.stack: list[tuple[ContextTree, int]] = [(self.root, 0)]

    def push(self, name: str, num_gates: int) -> None:
        node = self.stack[-1][0].child(name)
        self.stack.append((node, num_gates))

    def pop(self, num_gates: int) -> None:
        assert len(self.stack) > 1, "pop_context without matching push"
        node, entered = self.stack.pop()
        node.gate_count += num_gates - entered
