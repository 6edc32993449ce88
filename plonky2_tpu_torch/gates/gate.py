"""Gate base and evaluation algebras (reference gates/gate.rs:54 Gate,
:325 compute_filter).

A gate writes its constraints once, `eval_unfiltered(alg, ...)`, over an
algebra:
- `ExtAlgebra`: quadratic-extension python-int scalars, the verifier's
  evaluation at zeta;
- `GFAlgebra`: int64 field tensors over the whole LDE grid, the prover's
  quotient pass;
- `TargetAlgebra` (`target_algebra.py`): extension targets, the recursive
  verifier's constraints inside a circuit.
Gates whose generic form is slow on tensors override `eval_unfiltered_rows`.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..field import reference as ref

UNUSED_SELECTOR = (1 << 32) - 1  # u32::MAX (reference: selectors.rs:14)


class ExtAlgebra:
    """Quadratic-extension scalars as (c0, c1) python-int tuples."""

    add = staticmethod(ref.ext2_add)
    sub = staticmethod(ref.ext2_sub)
    mul = staticmethod(ref.ext2_mul)

    @staticmethod
    def mul_const(a, c):
        return ref.ext2_scalar_mul(a, c % ref.ORDER)

    @staticmethod
    def add_const(a, c):
        return (ref.add(a[0], c), a[1])

    @staticmethod
    def const(c):
        return (c % ref.ORDER, 0)

    @staticmethod
    def zero():
        return (0, 0)


EXT = ExtAlgebra()


class GFAlgebra:
    """Base-field int64 tensors of one shape on one device."""

    add = staticmethod(gl.add)
    sub = staticmethod(gl.sub)
    mul = staticmethod(gl.mul)
    mul_const = staticmethod(gl.mul_const)
    add_const = staticmethod(gl.add_const)

    def __init__(self, shape, device):
        self.shape = shape
        self.device = device

    def const(self, c: int) -> torch.Tensor:
        return gl.const(c, self.device, self.shape)

    def zero(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=torch.int64, device=self.device)


class Gate:
    """Base gate. `id()` is unique per configured gate type and is the sort
    key of the selector grouping (the reference's Debug-format ids)."""

    def id(self) -> str:
        raise NotImplementedError

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def num_ops(self) -> int:
        """Batched op slots per row (find_slot); 1 for unbatched gates."""
        return 1

    def extra_constant_wires(self):
        """[(constant_index, wire_index)] pairs that receive build-time
        constants (reference: gate.rs extra_constant_wires)."""
        return []

    def export_circom_verification_code(self) -> str:
        """okx addition (reference: gate.rs:67): a circom template of the
        gate's constraints, emitted through `eval_unfiltered`."""
        from ..utils.circom_export import export_circom_verification_code
        return export_circom_verification_code(self)

    def export_solidity_verification_code(self) -> str:
        """okx addition (reference: gate.rs:68)."""
        from ..utils.circom_export import export_solidity_verification_code
        return export_solidity_verification_code(self)

    def eval_unfiltered(self, alg, local_constants, local_wires,
                        public_inputs_hash):
        """Constraint values over `alg`; constants exclude selector columns."""
        raise NotImplementedError

    def eval_unfiltered_rows(self, consts_rows: torch.Tensor,
                             wires_rows: torch.Tensor,
                             pi_rows: torch.Tensor) -> torch.Tensor:
        """consts_rows [n_consts, N] (selectors removed), wires_rows
        [num_wires, N], pi_rows [4, N] -> [num_constraints, N]."""
        N = wires_rows.shape[-1]
        out = self.eval_unfiltered(GFAlgebra((N,), wires_rows.device),
                                   list(consts_rows), list(wires_rows),
                                   list(pi_rows))
        if not out:
            return wires_rows.new_zeros((0, N))
        return torch.stack(out)

    def generators(self, row: int, local_constants: list):
        return []

    def __eq__(self, other):
        return isinstance(other, Gate) and self.id() == other.id()

    def __hash__(self):
        return hash(self.id())


def compute_filter(alg, row: int, group_range: range, s,
                   many_selectors: bool):
    """prod_{i in group, i != row} (i - s), times (UNUSED - s) if more than
    one selector group exists (reference: gate.rs:325-337)."""
    acc = None
    idxs = [i for i in group_range if i != row]
    if many_selectors:
        idxs.append(UNUSED_SELECTOR)
    for i in idxs:
        term = alg.sub(alg.const(i), s)
        acc = term if acc is None else alg.mul(acc, term)
    assert acc is not None
    return acc
