"""Circuit-data checkpoint and load: (de)serialization of CommonCircuitData,
ProverOnlyData, VerifierOnlyData and the CircuitData splits (reference:
plonky2/src/util/serialization/mod.rs read/write_circuit_data:802,1812;
the JAX package's utils/circuit_serialization.py).

The container is the JAX package's: a zip archive of `structure.json` and
`blob_<n>.npy` entries. One structural codec covers every class: an object
is its qualified class name (the port's own) and its encoded `__dict__`;
numpy arrays are .npy blobs; tuples, ranges, dicts, bytes and extension
targets are tagged JSON. Only classes of this package are loaded.

The constants and sigmas commitment is stored as its coefficients; a load
rebuilds its LDE and Merkle tree on the device the caller names (the card
by default: K1, K3 and K2 there). Random-value generators share one numpy
Generator: the `rng` a load is given, else an unseeded one. Its state is not
stored, so a loaded prover does not replay the blinding values of the
circuit it was saved from unless its caller hands it that stream.
"""

from __future__ import annotations

import importlib
import io
import json
import zipfile

import numpy as np

PKG = __name__.split(".")[0]


class _Encoder:
    def __init__(self):
        self.blobs: list[np.ndarray] = []

    def enc(self, v):
        from ..iop.target import ExtTarget
        if isinstance(v, ExtTarget):
            return {"__ext__": [self.enc(v[0]), self.enc(v[1])]}
        if isinstance(v, bool) or v is None or isinstance(v, (int, str,
                                                              float)):
            return v
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, bytes):
            return {"__bytes__": v.hex()}
        if isinstance(v, tuple):
            return {"__t__": [self.enc(x) for x in v]}
        if isinstance(v, list):
            return [self.enc(x) for x in v]
        if isinstance(v, range):
            return {"__range__": [v.start, v.stop, v.step]}
        if isinstance(v, dict):
            return {"__d__": [[self.enc(k), self.enc(x)]
                              for k, x in v.items()]}
        if isinstance(v, np.ndarray):
            self.blobs.append(v)
            return {"__np__": len(self.blobs) - 1}
        if isinstance(v, np.random.Generator):
            return {"__rng__": 1}
        if hasattr(v, "__dict__"):
            cls = type(v)
            return {"__obj__": f"{cls.__module__}:{cls.__qualname__}",
                    "state": {k: self.enc(x) for k, x in v.__dict__.items()}}
        raise TypeError(f"cannot serialize {type(v)!r}: {v!r}")


class _Decoder:
    def __init__(self, blobs, rng):
        self.blobs = blobs
        self.rng = rng

    def dec(self, v):
        if isinstance(v, (bool, int, str, float)) or v is None:
            return v
        if isinstance(v, list):
            return [self.dec(x) for x in v]
        if "__ext__" in v:
            from ..iop.target import ExtTarget
            return ExtTarget(*(self.dec(x) for x in v["__ext__"]))
        if "__t__" in v:
            return tuple(self.dec(x) for x in v["__t__"])
        if "__bytes__" in v:
            return bytes.fromhex(v["__bytes__"])
        if "__range__" in v:
            return range(*v["__range__"])
        if "__d__" in v:
            return {self.dec(k): self.dec(x) for k, x in v["__d__"]}
        if "__np__" in v:
            return self.blobs[v["__np__"]]
        if "__rng__" in v:
            return self.rng
        if "__obj__" in v:
            mod_name, _, qual = v["__obj__"].partition(":")
            if mod_name.split(".")[0] != PKG:
                raise ValueError(f"refusing to load class {v['__obj__']}: "
                                 f"not of {PKG}")
            cls = importlib.import_module(mod_name)
            for part in qual.split("."):
                cls = getattr(cls, part)
            obj = cls.__new__(cls)
            obj.__dict__.update(
                {k: self.dec(x) for k, x in v["state"].items()})
            return obj
        raise TypeError(f"cannot deserialize {v!r}")


def _pack(structure: dict, blobs: list[np.ndarray]) -> bytes:
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("structure.json", json.dumps(structure))
        for i, b in enumerate(blobs):
            bio = io.BytesIO()
            np.save(bio, b, allow_pickle=False)
            z.writestr(f"blob_{i}.npy", bio.getvalue())
    return out.getvalue()


def _unpack(data: bytes, rng):
    z = zipfile.ZipFile(io.BytesIO(data))
    structure = json.loads(z.read("structure.json"))
    names = set(z.namelist())
    blobs = []
    while f"blob_{len(blobs)}.npy" in names:
        blobs.append(np.load(io.BytesIO(z.read(f"blob_{len(blobs)}.npy")),
                             allow_pickle=False))
    rng = np.random.default_rng() if rng is None else rng
    return structure, _Decoder(blobs, rng)


# ---------------------------------------------------------------------------
# the three parts
# ---------------------------------------------------------------------------

def _encode_common(common, enc: _Encoder) -> dict:
    return {
        "config": enc.enc(common.config),
        "fri_params": enc.enc(common.fri_params),
        "gates": [enc.enc(g) for g in common.gates],
        "selectors_info": enc.enc(common.selectors_info),
        "quotient_degree_factor": common.quotient_degree_factor,
        "num_gate_constraints": common.num_gate_constraints,
        "num_constants": common.num_constants,
        "num_public_inputs": common.num_public_inputs,
        "k_is": [int(k) for k in common.k_is],
        "num_partial_products": common.num_partial_products,
        "gc": common.gc.name,
    }


def _decode_common(d: dict, dec: _Decoder):
    from ..hash.hashers import CONFIGS
    from ..plonk.circuit_data import CommonCircuitData
    return CommonCircuitData(
        config=dec.dec(d["config"]),
        fri_params=dec.dec(d["fri_params"]),
        gates=[dec.dec(g) for g in d["gates"]],
        selectors_info=dec.dec(d["selectors_info"]),
        quotient_degree_factor=d["quotient_degree_factor"],
        num_gate_constraints=d["num_gate_constraints"],
        num_constants=d["num_constants"],
        num_public_inputs=d["num_public_inputs"],
        k_is=list(d["k_is"]),
        num_partial_products=d["num_partial_products"],
        gc=CONFIGS[d["gc"]],
    )


def _encode_prover_only(po, enc: _Encoder) -> dict:
    from ..field import goldilocks as gl
    return {
        "generators": [enc.enc(g) for g in po.generators],
        "constants_sigmas_coeffs": enc.enc(
            gl.to_u64(po.constants_sigmas_commitment.polynomials)),
        "sigmas": enc.enc(np.asarray(po.sigmas)),
        "subgroup": enc.enc(np.asarray(po.subgroup)),
        "public_inputs": enc.enc(list(po.public_inputs)),
        "representative_map": enc.enc(np.asarray(po.representative_map)),
        "circuit_digest": enc.enc(po.circuit_digest),
    }


def _decode_prover_only(d: dict, dec: _Decoder, common, device):
    """The prover's data, its constants and sigmas committed anew on
    `device` (the commitment is never blinded)."""
    from ..field import goldilocks as gl
    from ..fri.oracle import PolynomialBatch
    from ..plonk.circuit_data import ProverOnlyData
    fri = common.config.fri_config
    commitment = PolynomialBatch.from_coeffs(
        gl.from_u64(dec.dec(d["constants_sigmas_coeffs"]), device),
        fri.rate_bits, fri.cap_height, common.gc.hasher)
    return ProverOnlyData(
        generators=[dec.dec(g) for g in d["generators"]],
        constants_sigmas_commitment=commitment,
        sigmas=dec.dec(d["sigmas"]),
        subgroup=dec.dec(d["subgroup"]),
        public_inputs=dec.dec(d["public_inputs"]),
        representative_map=dec.dec(d["representative_map"]),
        circuit_digest=dec.dec(d["circuit_digest"]),
    )


def _encode_verifier_only(vo, enc: _Encoder) -> dict:
    return {"constants_sigmas_cap": enc.enc(list(vo.constants_sigmas_cap)),
            "circuit_digest": enc.enc(vo.circuit_digest)}


def _decode_verifier_only(d: dict, dec: _Decoder):
    from ..plonk.circuit_data import VerifierOnlyData
    return VerifierOnlyData(
        constants_sigmas_cap=dec.dec(d["constants_sigmas_cap"]),
        circuit_digest=dec.dec(d["circuit_digest"]))


def _serialize(common, prover_only=None, verifier_only=None) -> bytes:
    enc = _Encoder()
    structure = {"common": _encode_common(common, enc)}
    if prover_only is not None:
        structure["prover_only"] = _encode_prover_only(prover_only, enc)
    if verifier_only is not None:
        structure["verifier_only"] = _encode_verifier_only(verifier_only,
                                                           enc)
    return _pack(structure, enc.blobs)


def _deserialize(blob: bytes, device, rng):
    """(common, prover_only or None, verifier_only or None)."""
    structure, dec = _unpack(blob, rng)
    common = _decode_common(structure["common"], dec)
    po = structure.get("prover_only")
    vo = structure.get("verifier_only")
    return (common,
            None if po is None else _decode_prover_only(po, dec, common,
                                                        device),
            None if vo is None else _decode_verifier_only(vo, dec))


# ---------------------------------------------------------------------------
# entry points (reference: write_circuit_data / read_circuit_data and the
# prover- and verifier-only variants, serialization/mod.rs:802-1812). A load
# of prover data takes `device` (where the constants are committed; "cuda"
# by default) and `rng` (the random-value generators' Generator).
# ---------------------------------------------------------------------------

def serialize_common_circuit_data(common) -> bytes:
    return _serialize(common)


def deserialize_common_circuit_data(blob: bytes):
    return _deserialize(blob, None, None)[0]


def serialize_circuit_data(data) -> bytes:
    return _serialize(data.common, data.prover_only, data.verifier_only)


def deserialize_circuit_data(blob: bytes, device="cuda", rng=None):
    from ..plonk.circuit_data import CircuitData
    common, po, vo = _deserialize(blob, device, rng)
    return CircuitData(prover_only=po, verifier_only=vo, common=common)


def serialize_prover_circuit_data(pcd) -> bytes:
    return _serialize(pcd.common, prover_only=pcd.prover_only)


def deserialize_prover_circuit_data(blob: bytes, device="cuda", rng=None):
    from ..plonk.circuit_data import ProverCircuitData
    common, po, _ = _deserialize(blob, device, rng)
    return ProverCircuitData(prover_only=po, common=common)


def serialize_verifier_circuit_data(vcd) -> bytes:
    return _serialize(vcd.common, verifier_only=vcd.verifier_only)


def deserialize_verifier_circuit_data(blob: bytes):
    from ..plonk.circuit_data import VerifierCircuitData
    common, _, vo = _deserialize(blob, None, None)
    return VerifierCircuitData(verifier_only=vo, common=common)
