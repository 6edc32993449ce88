"""Proof bytes (reference: plonky2/src/util/serialization/mod.rs — Buffer:2166,
write_proof / read_proof). Layout follows the reference's conventions: u64
LE field elements, a u8 sibling count before each Merkle proof, every other
shape taken from CommonCircuitData. A digest is written as
GenericHashOut::to_bytes: 4 LE field elements, or the raw `hash_size` bytes
of a byte digest (Keccak's 25), in caps, Merkle paths and FRI commit caps;
the reader takes the shape of a digest from the config's hasher. Under a
zero-knowledge config the FRI initial-tree leaves of the wires, Z and
quotient oracles hold SALT_SIZE more elements (reference:
read_fri_initial_trees_proof, `salt_size(hiding)`).

Also here: compressed proofs (write_compressed_proof) and the verifier
data (write_verifier_only_circuit_data), in the JAX package's layouts."""

from __future__ import annotations

import io
import struct

import numpy as np

from ..field import reference as ref
from ..fri.oracle import SALT_SIZE
from ..fri.proof import (
    FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep,
)
from ..hash.hashers import digest_to_bytes
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs


class Buffer:
    def __init__(self, data: bytes = b""):
        self._r = io.BytesIO(data)
        self._w = io.BytesIO() if not data else None

    # -- writing ---------------------------------------------------------------
    def write_u8(self, x: int):
        self._w.write(struct.pack("<B", x))

    def write_u32(self, x: int):
        self._w.write(struct.pack("<I", x))

    def write_usize(self, x: int):
        self._w.write(struct.pack("<Q", x))

    def write_field(self, x: int):
        self._w.write(struct.pack("<Q", x % ref.ORDER))

    def write_field_vec(self, xs):
        for x in xs:
            self.write_field(int(x))

    def write_ext_vec(self, xs):
        for x in xs:
            self.write_field(int(x[0]))
            self.write_field(int(x[1]))

    def write_hash(self, h):
        self._w.write(digest_to_bytes(h))

    def write_cap(self, cap):
        for h in cap:
            self.write_hash(h)

    def bytes(self) -> bytes:
        return self._w.getvalue()

    # -- reading ---------------------------------------------------------------
    def read_u8(self) -> int:
        return struct.unpack("<B", self._r.read(1))[0]

    def read_field(self) -> int:
        return struct.unpack("<Q", self._r.read(8))[0]

    def read_field_vec(self, n) -> list:
        return [self.read_field() for _ in range(n)]

    def read_ext_vec(self, n) -> list:
        return [(self.read_field(), self.read_field()) for _ in range(n)]

    def read_u32(self) -> int:
        return struct.unpack("<I", self.read_bytes(4))[0]

    def read_usize(self) -> int:
        return struct.unpack("<Q", self.read_bytes(8))[0]

    def read_bytes(self, n: int) -> bytes:
        data = self._r.read(n)
        if len(data) != n:
            raise ValueError(f"proof bytes end {n - len(data)} bytes early")
        return data

    def read_hash(self, hasher):
        if not hasher.algebraic:
            return self.read_bytes(hasher.hash_size)
        return tuple(self.read_field_vec(4))

    def read_cap(self, cap_height: int, hasher) -> list:
        return [self.read_hash(hasher) for _ in range(1 << cap_height)]

    def read_merkle_proof(self, hasher) -> np.ndarray:
        """u8 sibling count, then the siblings: [k, digest_width] rows."""
        k = self.read_u8()
        if not hasher.algebraic:
            return np.frombuffer(self.read_bytes(k * hasher.hash_size),
                                 dtype=np.uint8).reshape(k, hasher.hash_size)
        return np.asarray(self.read_field_vec(4 * k),
                          dtype=np.uint64).reshape(k, 4)


def serialize_proof_with_pis(pwp: ProofWithPublicInputs, common) -> bytes:
    buf = Buffer()
    p = pwp.proof
    buf.write_cap(p.wires_cap)
    buf.write_cap(p.plonk_zs_partial_products_cap)
    buf.write_cap(p.quotient_polys_cap)
    o = p.openings
    for vec in (o.constants, o.plonk_sigmas, o.wires, o.plonk_zs,
                o.plonk_zs_next, o.partial_products, o.quotient_polys):
        buf.write_ext_vec(vec)
    _write_fri_proof(buf, p.opening_proof)
    buf.write_field_vec(pwp.public_inputs)
    return buf.bytes()


def deserialize_proof_with_pis(data: bytes, common) -> ProofWithPublicInputs:
    buf = Buffer(data)
    hasher = common.gc.hasher
    ch = common.config.fri_config.cap_height
    wires_cap = buf.read_cap(ch, hasher)
    zs_pp_cap = buf.read_cap(ch, hasher)
    quotient_cap = buf.read_cap(ch, hasher)
    o = OpeningSet(
        constants=buf.read_ext_vec(len(common.constants_range)),
        plonk_sigmas=buf.read_ext_vec(len(common.sigmas_range)),
        wires=buf.read_ext_vec(common.config.num_wires),
        plonk_zs=buf.read_ext_vec(len(common.zs_range)),
        plonk_zs_next=buf.read_ext_vec(len(common.zs_range)),
        partial_products=buf.read_ext_vec(len(common.partial_products_range)),
        quotient_polys=buf.read_ext_vec(common.num_quotient_polys),
    )
    opening_proof = _read_fri_proof(buf, common.fri_params,
                                    _initial_leaf_widths(common), hasher)
    public_inputs = buf.read_field_vec(common.num_public_inputs)
    return ProofWithPublicInputs(
        proof=Proof(wires_cap=wires_cap,
                    plonk_zs_partial_products_cap=zs_pp_cap,
                    quotient_polys_cap=quotient_cap,
                    openings=o, opening_proof=opening_proof),
        public_inputs=public_inputs)


def _initial_leaf_widths(common) -> list[int]:
    """The leaf width of each oracle's FRI initial tree: its polynomials,
    and its salt when the proof hides and the oracle is blinded."""
    salt = SALT_SIZE if common.fri_params.hiding else 0
    return [o.num_polys + (salt if o.blinding else 0)
            for o in common._fri_oracles()]


def _write_merkle_proof(buf: Buffer, sibs) -> None:
    """u8 sibling count, then the sibling digests (reference:
    serialization/mod.rs:1467 write_merkle_proof)."""
    n = len(sibs)
    assert n < 256, "Merkle proof length must fit in u8"
    buf.write_u8(n)
    buf.write_cap(sibs)


def _write_fri_proof(buf: Buffer, fp: FriProof) -> None:
    for cap in fp.commit_phase_merkle_caps:
        buf.write_cap(cap)
    for qr in fp.query_round_proofs:
        for evals, sibs in qr.initial_trees_proof.evals_proofs:
            buf.write_field_vec([int(x) for x in evals])
            _write_merkle_proof(buf, sibs)
        for step in qr.steps:
            buf.write_ext_vec(step.evals)
            _write_merkle_proof(buf, step.merkle_proof)
    buf.write_ext_vec(fp.final_poly)
    buf.write_field(int(fp.pow_witness))


def _read_fri_proof(buf: Buffer, fri_params, num_leaves_per_oracle,
                    hasher):
    cap_height = fri_params.config.cap_height
    caps = [buf.read_cap(cap_height, hasher)
            for _ in fri_params.reduction_arity_bits]
    rounds = []
    for _ in range(fri_params.config.num_query_rounds):
        evals_proofs = []
        for n_leaves in num_leaves_per_oracle:
            evals = np.asarray(buf.read_field_vec(n_leaves), dtype=np.uint64)
            evals_proofs.append((evals, buf.read_merkle_proof(hasher)))
        steps = []
        for arity_bits in fri_params.reduction_arity_bits:
            evals = buf.read_ext_vec(1 << arity_bits)
            steps.append(FriQueryStep(
                evals=evals, merkle_proof=buf.read_merkle_proof(hasher)))
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(evals_proofs=evals_proofs),
            steps=steps))
    final_poly = buf.read_ext_vec(fri_params.final_poly_len)
    pow_witness = buf.read_field()
    return FriProof(commit_phase_merkle_caps=caps, query_round_proofs=rounds,
                    final_poly=final_poly, pow_witness=pow_witness)


# ---------------------------------------------------------------------------
# Verifier data (reference: serialization/mod.rs:1924
# write_verifier_only_circuit_data: the cap's height, not its length, then
# the cap and the circuit digest)
# ---------------------------------------------------------------------------

def serialize_verifier_data(vd) -> bytes:
    buf = Buffer()
    n = len(vd.constants_sigmas_cap)
    height = n.bit_length() - 1
    assert 1 << height == n, n
    buf.write_usize(height)
    buf.write_cap(vd.constants_sigmas_cap)
    buf.write_hash(vd.circuit_digest)
    return buf.bytes()


def deserialize_verifier_data(data: bytes, hasher=None):
    """`hasher`: the config's hasher, which gives the digests' shape
    (default Poseidon's 4 elements)."""
    from ..hash.hashers import POSEIDON
    from ..plonk.circuit_data import VerifierOnlyData
    hasher = hasher or POSEIDON
    buf = Buffer(data)
    cap = buf.read_cap(buf.read_usize(), hasher)
    digest = buf.read_hash(hasher)
    return VerifierOnlyData(constants_sigmas_cap=cap, circuit_digest=digest)


# ---------------------------------------------------------------------------
# Compressed proofs (reference: serialization/mod.rs write_compressed_proof
# and write_compressed_fri_query_rounds:2032: the query indices as u32, then
# the deduplicated initial-tree proofs and each level's steps in the order
# of their sorted indices, with no counts or keys; the reader replays the
# folding of the indices)
# ---------------------------------------------------------------------------

def serialize_compressed_proof_with_pis(cpwp, common) -> bytes:
    buf = Buffer()
    p = cpwp.proof
    buf.write_cap(p.wires_cap)
    buf.write_cap(p.plonk_zs_partial_products_cap)
    buf.write_cap(p.quotient_polys_cap)
    o = p.openings
    for vec in (o.constants, o.plonk_sigmas, o.wires, o.plonk_zs,
                o.plonk_zs_next, o.partial_products, o.quotient_polys):
        buf.write_ext_vec(vec)
    fp = p.opening_proof
    for cap in fp.commit_phase_merkle_caps:
        buf.write_cap(cap)
    qrp = fp.query_round_proofs
    for i in qrp.indices:
        buf.write_u32(i)
    for idx in sorted(qrp.initial_trees_proofs):
        for evals, sibs in qrp.initial_trees_proofs[idx].evals_proofs:
            buf.write_field_vec([int(x) for x in evals])
            _write_merkle_proof(buf, sibs)
    for level in qrp.steps:
        for idx in sorted(level):
            buf.write_ext_vec(level[idx].evals)
            _write_merkle_proof(buf, level[idx].merkle_proof)
    buf.write_ext_vec(fp.final_poly)
    buf.write_field(int(fp.pow_witness))
    buf.write_field_vec(cpwp.public_inputs)
    return buf.bytes()


def deserialize_compressed_proof_with_pis(data: bytes, common):
    from ..fri.compressed import CompressedFriProof, CompressedFriQueryRounds
    from ..plonk.compressed_proof import (
        CompressedProof, CompressedProofWithPublicInputs,
    )
    buf = Buffer(data)
    hasher = common.gc.hasher
    ch = common.config.fri_config.cap_height
    wires_cap = buf.read_cap(ch, hasher)
    zs_pp_cap = buf.read_cap(ch, hasher)
    quotient_cap = buf.read_cap(ch, hasher)
    o = OpeningSet(
        constants=buf.read_ext_vec(len(common.constants_range)),
        plonk_sigmas=buf.read_ext_vec(len(common.sigmas_range)),
        wires=buf.read_ext_vec(common.config.num_wires),
        plonk_zs=buf.read_ext_vec(len(common.zs_range)),
        plonk_zs_next=buf.read_ext_vec(len(common.zs_range)),
        partial_products=buf.read_ext_vec(len(common.partial_products_range)),
        quotient_polys=buf.read_ext_vec(common.num_quotient_polys),
    )
    fri_params = common.fri_params
    caps = [buf.read_cap(ch, hasher) for _ in fri_params.reduction_arity_bits]
    indices = [buf.read_u32()
               for _ in range(fri_params.config.num_query_rounds)]

    def read_path():
        return [hasher.digest_from_row(row)
                for row in buf.read_merkle_proof(hasher)]

    keys = sorted(set(indices))
    initial = {}
    for idx in keys:
        initial[idx] = FriInitialTreeProof(evals_proofs=[
            (buf.read_field_vec(width), read_path())
            for width in _initial_leaf_widths(common)])
    steps = []
    for arity_bits in fri_params.reduction_arity_bits:
        keys = sorted(set(i >> arity_bits for i in keys))
        level = {}
        for idx in keys:
            evals = buf.read_ext_vec((1 << arity_bits) - 1)
            level[idx] = FriQueryStep(evals=evals, merkle_proof=read_path())
        steps.append(level)
    final_poly = buf.read_ext_vec(fri_params.final_poly_len)
    pow_witness = buf.read_field()
    public_inputs = buf.read_field_vec(common.num_public_inputs)
    return CompressedProofWithPublicInputs(
        proof=CompressedProof(
            wires_cap=wires_cap, plonk_zs_partial_products_cap=zs_pp_cap,
            quotient_polys_cap=quotient_cap, openings=o,
            opening_proof=CompressedFriProof(
                commit_phase_merkle_caps=caps,
                query_round_proofs=CompressedFriQueryRounds(
                    indices=indices, initial_trees_proofs=initial,
                    steps=steps),
                final_poly=final_poly, pow_witness=pow_witness)),
        public_inputs=public_inputs)
