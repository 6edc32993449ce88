"""Host C libraries: the Poseidon and Poseidon2 permutations
(`csrc/host_poseidon.c`) with the witness tape (`csrc/witness_tape.c`,
run by `iop/tape.py`) on their shared arithmetic (`csrc/host_goldilocks.h`),
and the PoseidonBN128 permutation (`csrc/bn128_poseidon.c`).

Each is built at first use with the host C compiler (`$CC`, else `cc`) into
`plonky2_tpu_torch/_build/`, named by a hash of its sources and the headers
they include, the compiler command and its constants header, which is
emitted from the port's own
`hash/poseidon_constants.py`, `hash/poseidon_fast.py` and
`hash/poseidon2_constants.py` (Poseidon, Poseidon2) or
`hash/poseidon_bn128.py` (BN128, in Montgomery form), and loaded with
ctypes. It is host code, not a kernel: where no compiler is found each
function returns None and its caller runs the same algebra in Python.
The BN128 batch entries split their rows over `threads` pthreads
(default `os.cpu_count()`); the bytes do not depend on the count.
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


def _build(src_names, header: dict, lib_name: str, flags=()):
    """ctypes handle to the library of the csrc/ files `src_names` (its C
    sources and the headers they include) with its generated `header`
    ({file name: text}), building it if needed; None when it cannot be
    built here."""
    paths = [os.path.join(CSRC_DIR, name) for name in src_names]
    srcs = [p for p in paths if p.endswith(".c")]
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", *flags]
    lib_path = os.path.join(
        BUILD_DIR, f"{lib_name}-{build_key(paths, header, cmd)}.so")
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
                subprocess.run([*cmd, "-I", tmp_dir, "-o", tmp, *srcs],
                               check=True, capture_output=True)
                os.replace(tmp, lib_path)
        return ctypes.CDLL(lib_path)
    except (OSError, subprocess.CalledProcessError):
        return None


def load():
    """ctypes handle to the Poseidon/Poseidon2 library, building it if
    needed; None when it cannot be built here."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib = _build(("host_poseidon.c", "witness_tape.c", "host_goldilocks.h"),
                 {"poseidon_constants_gen.h": _constants_header()},
                 "libplonky2_host")
    if lib is None:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name in PERMUTATIONS:
        getattr(lib, name).argtypes = [u64p]
        getattr(lib, name).restype = None
        getattr(lib, name + "_many").argtypes = [u64p, ctypes.c_size_t]
        getattr(lib, name + "_many").restype = None
    lib.poseidon_generator_trace.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.poseidon_generator_trace.restype = None
    # the tape and the store's arrays go as addresses (iop/tape.py)
    addr = ctypes.c_void_p
    lib.witness_tape_run.argtypes = [
        addr, ctypes.c_int64, addr, addr, addr,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.witness_tape_run.restype = ctypes.c_int64
    lib.wire_matrix_fill.argtypes = [addr, addr, ctypes.c_int64, addr, addr,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, addr]
    lib.wire_matrix_fill.restype = None
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
    getattr(lib, name + "_many")(_ptr(buf), buf.shape[0])
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


# ---------------------------------------------------------------------------
# PoseidonBN128 (the analog of the reference's Go static library,
# plonky2/build.rs:63-88, hash/poseidon_bn128.rs:60-100)
# ---------------------------------------------------------------------------

_BN_LIB = None
_BN_TRIED = False


def _bn128_header() -> str:
    """Round constants and MDS in Montgomery form (R = 2^256), and the field
    parameters, from the Grain derivation of `hash/poseidon_bn128.py`."""
    from .hash.poseidon_bn128 import P_BN254, _constants

    rc, mds = _constants()
    r = (1 << 256) % P_BN254

    def limbs(x):
        return ", ".join("0x%xULL" % ((x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
                         for i in range(4))

    def mont(values):
        return ",\n".join("  {%s}" % limbs(c * r % P_BN254) for c in values)

    p_inv = (-pow(P_BN254, -1, 1 << 64)) % (1 << 64)
    flat_rc = [c for row in rc for c in row]
    flat_mds = [c for row in mds for c in row]
    return ("/* generated by plonky2_tpu_torch/host.py */\n"
            "static const uint64_t P_LIMBS[4] = {%s};\n"
            "static const uint64_t P_INV = 0x%xULL;\n"
            "static const uint64_t R2_LIMBS[4] = {%s};\n"
            "static const uint64_t RC_MONT[%d][4] = {\n%s\n};\n"
            "static const uint64_t MDS_MONT[%d][4] = {\n%s\n};\n"
            % (limbs(P_BN254), p_inv, limbs(r * r % P_BN254), len(flat_rc),
               mont(flat_rc), len(flat_mds), mont(flat_mds)))


def load_bn128():
    """ctypes handle to the BN128 library, building it if needed; None when
    it cannot be built here."""
    global _BN_LIB, _BN_TRIED
    if _BN_LIB is not None or _BN_TRIED:
        return _BN_LIB
    _BN_TRIED = True
    lib = _build(("bn128_poseidon.c",),
                 {"bn128_constants_gen.h": _bn128_header()},
                 "libplonky2_bn128", ("-pthread",))
    if lib is None:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    size, threads = ctypes.c_size_t, ctypes.c_int
    for name, args in (
            ("bn128_permute", [u64p]),
            ("bn128_hash_no_pad", [u64p, size, u64p]),
            ("bn128_permute_many", [u64p, size, threads]),
            ("bn128_hash_leaves", [u64p, size, size, u64p, threads]),
            ("bn128_compress_many", [u64p, u64p, size, u64p, threads])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None
    _BN_LIB = lib
    return _BN_LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _check_rows(a: np.ndarray, width: int, what: str) -> None:
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{what} must be [n, {width}], got {a.shape}")


def _threads(threads) -> int:
    return int(threads) if threads else (os.cpu_count() or 1)


def bn128_permute(state):
    """12 ints -> the permuted 12 ints, or None without the library."""
    lib = load_bn128()
    if lib is None:
        return None
    buf = (ctypes.c_uint64 * 12)(*[int(x) for x in state])
    lib.bn128_permute(buf)
    return list(buf)


def bn128_hash_no_pad(inputs):
    """The rate-8 overwrite sponge of u64 ints -> 4 ints, or None."""
    lib = load_bn128()
    if lib is None:
        return None
    buf = (ctypes.c_uint64 * len(inputs))(*[int(x) for x in inputs])
    out = (ctypes.c_uint64 * 4)()
    lib.bn128_hash_no_pad(buf, len(inputs), out)
    return tuple(out)


def bn128_permute_many(states: np.ndarray, threads=None):
    """uint64 [n, 12] -> a permuted copy, or None without the library."""
    lib = load_bn128()
    if lib is None:
        return None
    buf = np.ascontiguousarray(states, dtype=np.uint64).copy()
    _check_rows(buf, 12, "bn128_permute_many: states")
    lib.bn128_permute_many(_ptr(buf), buf.shape[0], _threads(threads))
    return buf


def bn128_hash_leaves(leaves: np.ndarray, threads=None):
    """hash_or_noop over uint64 [n, L] rows -> [n, 4], or None."""
    lib = load_bn128()
    if lib is None:
        return None
    a = np.ascontiguousarray(leaves, dtype=np.uint64)
    _check_rows(a, a.shape[-1], "bn128_hash_leaves: leaves")
    out = np.empty((a.shape[0], 4), dtype=np.uint64)
    lib.bn128_hash_leaves(_ptr(a), a.shape[0], a.shape[1], _ptr(out),
                          _threads(threads))
    return out


def bn128_compress_many(left: np.ndarray, right: np.ndarray, threads=None):
    """two_to_one over uint64 [n, 4] digest pairs -> [n, 4], or None."""
    lib = load_bn128()
    if lib is None:
        return None
    lt = np.ascontiguousarray(left, dtype=np.uint64)
    rt = np.ascontiguousarray(right, dtype=np.uint64)
    _check_rows(lt, 4, "bn128_compress_many: left")
    _check_rows(rt, 4, "bn128_compress_many: right")
    if lt.shape != rt.shape:
        raise ValueError(f"bn128_compress_many: {lt.shape} vs {rt.shape}")
    out = np.empty((lt.shape[0], 4), dtype=np.uint64)
    lib.bn128_compress_many(_ptr(lt), _ptr(rt), lt.shape[0], _ptr(out),
                            _threads(threads))
    return out
