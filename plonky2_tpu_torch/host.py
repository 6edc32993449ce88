"""Host C library for the Poseidon and Poseidon2 permutations
(`csrc/host_poseidon.c`).

Built at first use with the host C compiler (`$CC`, else `cc`) into
`plonky2_tpu_torch/_build/`, named by a hash of the source, the compiler
command and its constants header, which is emitted from the
port's own `hash/poseidon_constants.py`, `hash/poseidon_fast.py` and
`hash/poseidon2_constants.py`, and loaded with ctypes. It is host code,
not a kernel: where no compiler is found each function returns None and
its caller runs the same algebra in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from .backend import BUILD_DIR, CSRC_DIR, build_key

PERMUTATIONS = ("poseidon_permute", "poseidon2_permute")

_LIB = None
_TRIED = False


def _constants_header() -> str:
    from .hash.poseidon_constants import (
        ALL_ROUND_CONSTANTS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG,
    )
    from .hash.poseidon2_constants import (
        MATRIX_DIAG_12, RC12, ROUNDS_F, ROUNDS_P,
    )
    from .hash.poseidon_fast import fast_partial_tables

    first_rc, partial_rc, vs, w_hats, init_mat = fast_partial_tables()
    flat = lambda rows: [x for row in rows for x in row]
    half_f = ROUNDS_F // 2
    tables = (("ROUND_CONSTANTS", ALL_ROUND_CONSTANTS),
              ("MDS_CIRC", MDS_MATRIX_CIRC), ("MDS_DIAG", MDS_MATRIX_DIAG),
              ("FAST_FIRST_RC", first_rc), ("FAST_PARTIAL_RC", partial_rc),
              ("FAST_VS", flat(vs)), ("FAST_W_HATS", flat(w_hats)),
              ("FAST_INIT_MAT", flat(init_mat)),
              ("P2_FULL_RC", flat(RC12[:half_f] + RC12[half_f + ROUNDS_P:])),
              ("P2_PARTIAL_RC", [RC12[half_f + r][0]
                                 for r in range(ROUNDS_P)]),
              ("P2_DIAG", MATRIX_DIAG_12))
    return "/* generated by plonky2_tpu_torch/host.py */\n" + "".join(
        "static const uint64_t %s[%d] = {\n%s\n};\n" % (
            name, len(vals), ",\n".join("  %dULL" % v for v in vals))
        for name, vals in tables)


def load():
    """ctypes handle to the host library, building it if needed; None when
    it cannot be built here."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(CSRC_DIR, "host_poseidon.c")
    header = {"poseidon_constants_gen.h": _constants_header()}
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC"]
    lib_path = os.path.join(
        BUILD_DIR, f"libplonky2_host-{build_key([src], header, cmd)}.so")
    try:
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # a private header directory and an atomic rename: test workers
            # may build at the same time
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
                for name, text in header.items():
                    with open(os.path.join(tmp_dir, name), "w") as f:
                        f.write(text)
                tmp = os.path.join(tmp_dir, "lib.so")
                subprocess.run([*cmd, "-I", tmp_dir, "-o", tmp, src],
                               check=True, capture_output=True)
                os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
    except (OSError, subprocess.CalledProcessError):
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name in PERMUTATIONS:
        getattr(lib, name).argtypes = [u64p]
        getattr(lib, name).restype = None
        getattr(lib, name + "_many").argtypes = [u64p, ctypes.c_size_t]
        getattr(lib, name + "_many").restype = None
    lib.poseidon_generator_trace.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.poseidon_generator_trace.restype = None
    _LIB = lib
    return _LIB


def permute(name: str, state):
    """Permutation `name` (one of PERMUTATIONS) of 12 canonical ints -> the
    permuted 12 ints, or None without the library."""
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint64 * 12)(*[int(x) for x in state])
    getattr(lib, name)(buf)
    return list(buf)


def permute_many(name: str, states: np.ndarray):
    """Permutation `name` of uint64 [n, 12] -> a permuted copy, or None
    without the library."""
    lib = load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(states, dtype=np.uint64).copy()
    getattr(lib, name + "_many")(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), buf.shape[0])
    return buf


def poseidon_generator_trace(inputs, swap: int):
    """The PoseidonGate's 135 wire values for 12 canonical inputs and the
    swap bit, or None without the library."""
    lib = load()
    if lib is None:
        return None
    buf_in = (ctypes.c_uint64 * 12)(*inputs)
    buf_out = (ctypes.c_uint64 * 135)()
    lib.poseidon_generator_trace(buf_in, int(swap), buf_out)
    return buf_out[:]
