"""Kernel build, binding and bookkeeping.

The CUDA sources in `csrc/` are compiled with nvcc for sm_90a into one shared
library with a plain C interface, named by a hash of the sources and the
generated constant tables, and loaded with ctypes, the first time a kernel
is launched (or when `build()` is called). Every C entry returns
`cudaGetLastError()`; `check()` raises on a non-zero code.

Each kernel has a `Kernel` record here: a launch count (a plain integer that
its wrapper raises by one per launch) and the launches per distinct shape, in
the order first seen, so a run can show which kernels the main path went
through and replay them against their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]


class Kernel:
    """Launch bookkeeping of one hand-written kernel."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source          # path in the repo
        self.replaces = replaces      # file:line of the TPU kernel
        self.launches = 0
        self.shapes: dict[tuple, int] = {}     # shape -> launches

    def launched(self, shape: tuple) -> None:
        self.launches += 1
        self.shapes[shape] = self.shapes.get(shape, 0) + 1


KERNELS = {
    # both entries, ntt_forward and ntt_inverse; a shape is (batch, lg_n,
    # rate_bits, "forward" or "inverse", shift or None)
    "ntt": Kernel(
        "ntt", "plonky2_tpu_torch/csrc/ntt.cu",
        "plonky2_tpu/ops/ntt_mxu_pallas.py:94"),
    "poseidon_permute": Kernel(
        "poseidon_permute", "plonky2_tpu_torch/csrc/poseidon.cu",
        "plonky2_tpu/ops/pallas_poseidon.py:335"),
    "poseidon_merkle_tree": Kernel(
        "poseidon_merkle_tree", "plonky2_tpu_torch/csrc/poseidon.cu",
        "plonky2_tpu/ops/pallas_poseidon.py:335"),
    "poseidon_hash_leaves": Kernel(
        "poseidon_hash_leaves", "plonky2_tpu_torch/csrc/poseidon.cu",
        "plonky2_tpu/ops/pallas_poseidon.py:410"),
    "poseidon2_permute": Kernel(
        "poseidon2_permute", "plonky2_tpu_torch/csrc/poseidon2.cu",
        "plonky2_tpu/ops/pallas_poseidon2.py:124"),
    "poseidon2_merkle_tree": Kernel(
        "poseidon2_merkle_tree", "plonky2_tpu_torch/csrc/poseidon2.cu",
        "plonky2_tpu/ops/pallas_poseidon2.py:124"),
    "poseidon2_hash_leaves": Kernel(
        "poseidon2_hash_leaves", "plonky2_tpu_torch/csrc/poseidon2.cu",
        "plonky2_tpu/ops/pallas_poseidon2.py:161"),
    # the elementwise field arithmetic of field/goldilocks.py (entry
    # field_binary) and field/extension.py (field_ext); a shape is (op,
    # output shape). No Pallas kernel: the JAX package's is jnp, fused by XLA
    "field": Kernel(
        "field", "plonky2_tpu_torch/csrc/field.cu",
        "none (plonky2_tpu/field/goldilocks.py, jnp)"),
    "field_ext": Kernel(
        "field_ext", "plonky2_tpu_torch/csrc/field.cu",
        "none (plonky2_tpu/field/extension.py, jnp)"),
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.shapes.clear()


_LIB = None
PTXAS_REPORT = ""     # nvcc's -Xptxas -v output of the last build here


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_key(paths, generated: dict, flags) -> str:
    """A hash of the source files, the generated headers ({name: text}) and
    the compiler command: a library is named by it, so a build from other
    sources, other constants or another compiler is never loaded."""
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    for name in sorted(generated):
        h.update(name.encode() + b"\0" + generated[name].encode())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def _tables_text(tables) -> str:
    """(name, values) pairs as `__constant__ uint64_t` arrays, or
    (name, values, "uint32_t") as 32-bit ones."""
    def array(name, vals, ctype="uint64_t"):
        digits = 16 if ctype == "uint64_t" else 8
        suffix = "ULL" if ctype == "uint64_t" else "U"
        return "__constant__ %s %s[%d] = {\n%s};\n" % (
            ctype, name, len(vals), ",\n".join(
                "  0x%0*x%s" % (digits, v, suffix) for v in vals))
    return "// generated by plonky2_tpu_torch/backend.py\n#pragma once\n" + \
        "".join(array(*t) for t in tables)


def _tables() -> dict:
    """The kernels' constant-table headers, generated from the port's
    constants: Poseidon's round constants (with a last row of zeros), its
    12 x 12 MDS matrix (circulant plus diagonal, as 32-bit entries), the
    constants added after each full round of the fast-partial-round form
    (rows 1-3, the first partial constants, rows 27-29, zeros) and that
    form's partial-round tables;
    Poseidon2's constants added after each of its 9 external layers (the
    oracle's rows RC12[0..4), zeros before the internal rounds, RC12[27..30),
    zeros after the last), its internal-round constants RC12[4 + r][0], the
    constants RC12[26] added after the internal rounds, the internal
    diagonal, and the external matrix (2 M4 on the diagonal blocks, M4 off
    them) as 32-bit entries."""
    from .hash.poseidon2 import external_matrix
    from .hash.poseidon2_constants import (
        MATRIX_DIAG_12, RC12, ROUNDS_F, ROUNDS_P,
    )
    from .hash.poseidon_constants import ALL_ROUND_CONSTANTS, SPONGE_WIDTH
    from .hash.poseidon_fast import _mds_matrix, fast_partial_tables

    first_rc, partial_rc, vs, w_hats, init_mat = fast_partial_tables()
    flat = lambda rows: [x for row in rows for x in row]
    w, half_f = SPONGE_WIDTH, ROUNDS_F // 2
    rc = list(ALL_ROUND_CONSTANTS) + [0] * w
    row = lambda r: rc[w * r:w * (r + 1)]
    zeros = [0] * w
    mid = half_f + ROUNDS_P
    return {
        "poseidon_tables.h": _tables_text((
            ("C_RC", rc), ("C_MDS", flat(_mds_matrix()), "uint32_t"),
            ("C_FULL_RC", flat([row(1), row(2), row(3), first_rc,
                                row(27), row(28), row(29), row(30)])),
            ("C_PARTIAL_RC", partial_rc), ("C_VS", flat(vs)),
            ("C_W_HATS", flat(w_hats)), ("C_INIT_MAT", flat(init_mat)))),
        "poseidon2_tables.h": _tables_text((
            ("C2_EXT_RC", flat(RC12[:half_f] + [zeros] + RC12[mid + 1:]
                               + [zeros])),
            ("C2_PARTIAL_RC", [RC12[half_f + r][0]
                               for r in range(ROUNDS_P)]),
            ("C2_MID_RC", RC12[mid]),
            ("C2_DIAG", MATRIX_DIAG_12),
            ("C2_EXT", flat(external_matrix()), "uint32_t"))),
    }


def build() -> float:
    """Compile `csrc/*.cu` with nvcc into one library under BUILD_DIR, named
    by `build_key` of the sources and table headers (skipped when that
    library exists), and load it. One nvcc per source, all started together,
    then one link, all in a private directory; the library is renamed into
    place. Their ptxas reports (registers, spills) go to PTXAS_REPORT.
    Returns the seconds spent."""
    global _LIB, PTXAS_REPORT
    t0 = time.perf_counter()
    names = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith((".cu",
                                                                  ".cuh")))
    sources = [os.path.join(CSRC_DIR, f) for f in names if f.endswith(".cu")]
    tables = _tables()
    key = build_key([os.path.join(CSRC_DIR, f) for f in names], tables,
                    NVCC_FLAGS)
    lib_path = os.path.join(BUILD_DIR, f"libplonky2_kernels-{key}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            for name, text in tables.items():
                with open(os.path.join(tmp, name), "w") as f:
                    f.write(text)
            jobs = []
            for src in sources:
                obj = os.path.join(tmp, os.path.basename(src) + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-I", tmp,
                       "-I", CSRC_DIR, "-o", obj, src]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            report = []
            for cmd, obj, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed:\n%s\n%s" % (
                        " ".join(cmd), err))
                report.append(err)
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o",
                   os.path.join(tmp, "lib.so"), *(obj for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed:\n%s\n%s" % (
                    " ".join(cmd), proc.stderr))
            os.replace(os.path.join(tmp, "lib.so"), lib_path)
        PTXAS_REPORT = "".join(report)
    lib = ctypes.CDLL(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out_count = ctypes.POINTER(ctypes.c_int)
    lib.ntt_forward.argtypes = [p, p, ll, ll, i, i, p, p, p, out_count]
    lib.ntt_inverse.argtypes = [p, p, ll, i, p, p, p, out_count]
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    for name in ("poseidon_permute", "poseidon2_permute"):
        getattr(lib, name).argtypes = [p, p, ll, p]
    for name in ("poseidon_hash_leaves", "poseidon2_hash_leaves"):
        getattr(lib, name).argtypes = [p, p, i, ll, p]
    for name in ("poseidon_merkle_tree", "poseidon2_merkle_tree"):
        getattr(lib, name).argtypes = [p, p, ll, i, p, out_count]
    plan = ctypes.c_char_p       # packed 64-bit words
    lib.field_binary.argtypes = [i, p, plan, p]
    lib.field_ext.argtypes = [i, p, p, plan, p]
    for name in [k for k in KERNELS if k not in ("ntt", "field")] + [
            "ntt_forward", "ntt_inverse", "field_binary"]:
        getattr(lib, name).restype = i
    _LIB = lib
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library, building it at first use."""
    if _LIB is None:
        build()
    return _LIB


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _LIB.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def require_cuda_int64(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda or t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous int64 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")


def stream(t: torch.Tensor) -> int:
    """The current stream of t's device, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def call(entry: str, t: torch.Tensor, *args) -> int:
    """C entry `entry` of the library on `args`, with t's device current:
    the entries key their per-device state (K1's shared-memory attribute,
    the SM count of the sponge grids) by `cudaGetDevice`. The device is
    switched only when it is not current already (a field op costs
    microseconds of host time)."""
    fn = getattr(lib(), entry)
    if t.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(t.device):
        return fn(*args)


def plain_path(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version); False for
    a CUDA tensor (the wrapper launches its kernel); raises otherwise."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{name}: no kernel for device {t.device}")
