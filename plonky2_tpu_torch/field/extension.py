"""Quadratic extension F_p[X]/(X^2 - 7): arrays of c0 + c1*X as a pair of
int64 field tensors (reference layout of plonky2_tpu/field/extension.py).

`+`, `-` and `*` take the plain version (`add_plain`, ...) for CPU tensors
and, for CUDA tensors, one launch of csrc/field.cu (`field_ext`) that
writes both limbs."""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
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
        if backend.plain_path(gl.lead(self.c0, o.c0), "GF2.__add__"):
            return add_plain(self, o)
        return _ext("add", self, o)

    def __sub__(self, o: "GF2") -> "GF2":
        if backend.plain_path(gl.lead(self.c0, o.c0), "GF2.__sub__"):
            return sub_plain(self, o)
        return _ext("sub", self, o)

    def __mul__(self, o: "GF2") -> "GF2":
        if backend.plain_path(gl.lead(self.c0, o.c0), "GF2.__mul__"):
            return mul_plain(self, o)
        return _ext("mul", self, o)

    def reduce_sum(self, dim=0) -> "GF2":
        return GF2(gl.reduce_sum(self.c0, dim), gl.reduce_sum(self.c1, dim))

    def to_pairs(self) -> list:
        return list(zip(gl.to_ints(self.c0), gl.to_ints(self.c1)))


def add_plain(a: GF2, b: GF2) -> GF2:
    return GF2(gl.add_plain(a.c0, b.c0), gl.add_plain(a.c1, b.c1))


def sub_plain(a: GF2, b: GF2) -> GF2:
    return GF2(gl.sub_plain(a.c0, b.c0), gl.sub_plain(a.c1, b.c1))


def mul_plain(a: GF2, b: GF2) -> GF2:
    a0, a1, b0, b1 = a.c0, a.c1, b.c0, b.c1
    return GF2(gl.add_plain(gl.mul_plain(a0, b0),
                            gl.mul_small_plain(gl.mul_plain(a1, b1), W)),
               gl.add_plain(gl.mul_plain(a0, b1), gl.mul_plain(a1, b0)))


def _ext(name: str, a: GF2, b: GF2) -> GF2:
    """One launch of `field_ext` (op `name`) over a and b. The limbs of an
    operand share their shape, so both output limbs have the broadcast
    shape of all four."""
    for x in (a, b):
        if x.c0.shape != x.c1.shape:
            raise ValueError(f"GF2 {name}: limbs of shapes "
                             f"{tuple(x.c0.shape)} and {tuple(x.c1.shape)}")
    xs = (a.c0, a.c1, b.c0, b.c1)
    device, shape, words = gl.plan(name, xs)
    c0, c1 = gl.empty(xs, shape, device), gl.empty(xs, shape, device)
    if c0.numel():
        backend.check(backend.call(
            "field_ext", c0, gl.EXT_OPS[name], c0.data_ptr(), c1.data_ptr(),
            words, backend.stream(c0)), "field_ext")
        backend.KERNELS["field_ext"].launched((name, tuple(shape)))
    return GF2(c0, c1)


def gf2_powers(base, n: int, device) -> GF2:
    """[1, b, ..., b^{n-1}] for a host extension element b = (c0, c1), by
    log-doubling."""
    out = GF2.const((1, 0), device, (1,))
    while out.shape[0] < n:
        k = out.shape[0]
        step = GF2.const(ref.ext2_exp(tuple(base), k), device)
        out = GF2.cat([out, out * step])
    return out[:n]
