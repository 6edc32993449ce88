"""Quadratic extension F_p[X]/(X^2 - 7): arrays of c0 + c1*X as a pair of
int64 field tensors (reference layout of plonky2_tpu/field/extension.py)."""

from __future__ import annotations

import dataclasses

import torch

from . import reference as ref

from . import goldilocks as gl

W = 7


@dataclasses.dataclass(frozen=True)
class GF2:
    c0: torch.Tensor
    c1: torch.Tensor

    @staticmethod
    def const(c, device, shape=()) -> "GF2":
        return GF2(gl.const(c[0], device, shape),
                   gl.const(c[1], device, shape))

    @staticmethod
    def zeros(shape, device) -> "GF2":
        z = torch.zeros(shape, dtype=torch.int64, device=device)
        return GF2(z, z.clone())

    @property
    def shape(self):
        return self.c0.shape

    def __getitem__(self, idx) -> "GF2":
        return GF2(self.c0[idx], self.c1[idx])

    def reshape(self, *shape) -> "GF2":
        return GF2(self.c0.reshape(*shape), self.c1.reshape(*shape))

    @staticmethod
    def cat(parts, dim=0) -> "GF2":
        return GF2(torch.cat([p.c0 for p in parts], dim),
                   torch.cat([p.c1 for p in parts], dim))

    def __add__(self, o: "GF2") -> "GF2":
        return GF2(gl.add(self.c0, o.c0), gl.add(self.c1, o.c1))

    def __sub__(self, o: "GF2") -> "GF2":
        return GF2(gl.sub(self.c0, o.c0), gl.sub(self.c1, o.c1))

    def __mul__(self, o: "GF2") -> "GF2":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return GF2(gl.add(gl.mul(a0, b0), gl.mul_small(gl.mul(a1, b1), W)),
                   gl.add(gl.mul(a0, b1), gl.mul(a1, b0)))

    def reduce_sum(self, dim=0) -> "GF2":
        return GF2(gl.reduce_sum(self.c0, dim), gl.reduce_sum(self.c1, dim))

    def to_pairs(self) -> list:
        return list(zip(gl.to_ints(self.c0), gl.to_ints(self.c1)))


def gf2_powers(base, n: int, device) -> GF2:
    """[1, b, ..., b^{n-1}] for a host extension element b = (c0, c1), by
    log-doubling."""
    out = GF2.const((1, 0), device, (1,))
    while out.shape[0] < n:
        k = out.shape[0]
        step = GF2.const(ref.ext2_exp(tuple(base), k), device)
        out = GF2.cat([out, out * step])
    return out[:n]
