"""Kernel build, binding and bookkeeping.

The CUDA sources in `csrc/` are compiled with nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes, the first time a kernel
is launched (or when `build()` is called). Every C entry returns
`cudaGetLastError()`; `check()` raises on a non-zero code.

Each kernel has a `Kernel` record here: a launch count (a plain integer that
its wrapper raises by one per launch) and the ordered list of distinct shapes
it was launched at, so a run can show which kernels the main path went
through and replay them against their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libplonky2_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class Kernel:
    """Launch bookkeeping of one hand-written kernel."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source          # path in the repo
        self.replaces = replaces      # file:line of the TPU kernel
        self.launches = 0
        self.shapes: list[tuple] = []

    def launched(self, shape: tuple) -> None:
        self.launches += 1
        if shape not in self.shapes:
            self.shapes.append(shape)


KERNELS = {
    "ntt_dit": Kernel(
        "ntt_dit", "plonky2_tpu_torch/csrc/ntt.cu",
        "plonky2_tpu/ops/ntt_mxu_pallas.py:94"),
    "poseidon_permute": Kernel(
        "poseidon_permute", "plonky2_tpu_torch/csrc/poseidon.cu",
        "plonky2_tpu/ops/pallas_poseidon.py:335"),
    "poseidon_hash_leaves": Kernel(
        "poseidon_hash_leaves", "plonky2_tpu_torch/csrc/poseidon.cu",
        "plonky2_tpu/ops/pallas_poseidon.py:410"),
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.shapes.clear()


_LIB = None


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _emit_poseidon_header(path: str) -> None:
    """Poseidon tables as `__constant__` arrays, generated from the
    reference's constants and the derived fast-partial-round tables."""
    from plonky2_tpu.hash.poseidon_constants import (
        ALL_ROUND_CONSTANTS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG,
    )
    from plonky2_tpu.hash.poseidon_fast import fast_partial_tables

    first_rc, partial_rc, vs, w_hats, init_mat = fast_partial_tables()
    flat = lambda rows: [x for row in rows for x in row]
    tables = (("C_RC", ALL_ROUND_CONSTANTS), ("C_MDS_CIRC", MDS_MATRIX_CIRC),
              ("C_MDS_DIAG", MDS_MATRIX_DIAG), ("C_FIRST_RC", first_rc),
              ("C_PARTIAL_RC", partial_rc), ("C_VS", flat(vs)),
              ("C_W_HATS", flat(w_hats)), ("C_INIT_MAT", flat(init_mat)))
    with open(path, "w") as f:
        f.write("// generated by plonky2_tpu_torch/backend.py\n#pragma once\n")
        for name, vals in tables:
            f.write("__constant__ uint64_t %s[%d] = {\n%s};\n" % (
                name, len(vals),
                ",\n".join("  0x%016xULL" % v for v in vals)))


def build() -> float:
    """Compile `csrc/*.cu` into BUILD_DIR (skipped when the library is newer
    than every source) and load it. Returns the seconds spent."""
    global _LIB
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cu"))
    deps = sources + [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                      if f.endswith(".cuh")]
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stale = (not os.path.exists(lib_path)
             or os.path.getmtime(lib_path) < max(map(os.path.getmtime, deps)))
    if stale:
        _emit_poseidon_header(os.path.join(BUILD_DIR, "poseidon_tables.h"))
        tmp = lib_path + ".tmp%d" % os.getpid()
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", BUILD_DIR, "-I", CSRC_DIR,
               "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n%s\n%s" % (" ".join(cmd),
                                                         proc.stderr))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ntt_dit.argtypes = [p, p, ll, i, i, p]
    lib.poseidon_permute.argtypes = [p, p, ll, p]
    lib.poseidon_hash_leaves.argtypes = [p, p, i, ll, p]
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    for fn in (lib.ntt_dit, lib.poseidon_permute, lib.poseidon_hash_leaves):
        fn.restype = i
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
    return torch.cuda.current_stream(t.device).cuda_stream


def plain_path(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version); False for
    a CUDA tensor (the wrapper launches its kernel); raises otherwise."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{name}: no kernel for device {t.device}")
