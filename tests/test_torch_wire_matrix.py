"""The wire matrix of `iop/witness.py` (`wire_matrix`, `full_witness`) and
its upload (`plonk/prover.py` `_upload_wires`) against the dense walk over
every wire slot that built it before, kept here as the plain reference;
the circuit's layout (`PartitionLayout`), built once and shared read-only
by its proofs; and the `wire matrix` span and `wire_values` count.

Random partitions of a small target space: unset slots, values of p - 1
and of 2^63 and above, virtual targets past the wire slots, B = 1 and
B = 4, the matrix filled in C and in numpy. Tolerance: exact (bit for
bit)."""

import numpy as np
import pytest

from plonky2_tpu_torch import host
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.target import wire
from plonky2_tpu_torch.iop.witness import (PartialWitness, PartitionLayout,
                                           PartitionWitness, wire_matrix)
from plonky2_tpu_torch.plonk import prover
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.utils.timing import TimingTree

P = (1 << 64) - (1 << 32) + 1
NUM_WIRES, DEGREE, VIRTUALS = 7, 16, 40
# values each witness sets besides uniform ones: p - 1, 2^63 and above,
# and inputs of p and above, which `set` reduces
EDGES = (P - 1, 1 << 63, (1 << 63) + 12345, P - 2, P, P + 7, 0, 1)


def dense_walk(witness) -> np.ndarray:
    """The wire matrix as it was built before: a Python walk over every
    wire slot through the representative list, None as 0."""
    n, w = witness.degree, witness.num_wires
    values = witness.as_list()
    flat = np.asarray(
        [v if v is not None else 0
         for v in (values[r] for r in witness.rep_list[: n * w])],
        dtype=np.uint64)
    return flat.reshape(n, w).T.copy()


def random_map(rng) -> np.ndarray:
    """A representative map of a random partition of the wire slots and the
    virtual targets: each class's representative is a random member."""
    size = NUM_WIRES * DEGREE + VIRTUALS
    classes = rng.integers(0, size // 3, size)
    rep = np.empty(size, dtype=np.int64)
    for c in np.unique(classes):
        members = np.flatnonzero(classes == c)
        rep[members] = rng.choice(members)
    return rep


def targets():
    return ([wire(r, c) for r in range(DEGREE) for c in range(NUM_WIRES)]
            + [("v", i) for i in range(VIRTUALS)])


def fill(witness, rng, share: float) -> None:
    """Set a random share of the targets (virtual ones among them), the
    edge values first; a target whose partition is set is skipped."""
    chosen = [t for t in targets() if rng.random() < share]
    rng.shuffle(chosen)
    for i, t in enumerate(chosen):
        value = (EDGES[i] if i < len(EDGES)
                 else int(rng.integers(0, P, dtype=np.uint64)))
        if not witness.is_set(t):
            witness.set(t, value)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("share", [0.0, 0.05, 0.5, 1.0])
def test_full_witness_equals_the_dense_walk(seed, share):
    rng = np.random.default_rng([seed, int(share * 100)])
    witness = PartitionWitness(random_map(rng), NUM_WIRES, DEGREE)
    fill(witness, rng, share)
    want = dense_walk(witness)
    got = witness.full_witness()
    assert got.dtype == np.uint64 and got.shape == (NUM_WIRES, DEGREE)
    np.testing.assert_array_equal(got, want)
    assert int(want.max(initial=0)) < P
    if share == 1.0:
        assert (want >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("B", [1, 4])
def test_wire_matrix_of_b_witnesses(seed, B):
    """B witnesses of one layout: [num_wires, B, degree], each proof's
    slice its own dense walk, and the upload's int64 bits those of
    `gl.from_u64` of the stacked walks."""
    rng = np.random.default_rng([seed, B])
    layout = PartitionLayout(random_map(rng), NUM_WIRES, DEGREE)
    witnesses = [PartitionWitness(layout, NUM_WIRES, DEGREE)
                 for _ in range(B)]
    for b, w in enumerate(witnesses):
        # a witness with nothing set follows a full one
        fill(w, rng, (0.9, 0.0, 1.0, 0.3)[b] if B > 1 else 0.6)
    want = np.stack([dense_walk(w) for w in witnesses], axis=1)
    got = wire_matrix(witnesses)
    assert got.shape == (NUM_WIRES, B, DEGREE) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    uploaded = prover._upload_wires(witnesses, "cpu")
    assert uploaded.dtype == gl.from_u64(want, "cpu").dtype
    assert uploaded.shape == (NUM_WIRES, B, DEGREE)
    assert bool((uploaded == gl.from_u64(want, "cpu")).all())
    # the matrix left the witnesses and the layout as they were
    np.testing.assert_array_equal(wire_matrix(witnesses), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("B", [1, 4])
def test_numpy_fill_equals_the_c_fill(seed, B, monkeypatch):
    """Without the host C library the matrix is filled in numpy: the same
    matrix, bit for bit, and each proof's slice its dense walk."""
    if host.load() is None:
        pytest.fail("the host C library does not build here")
    rng = np.random.default_rng([seed, B, 2])
    layout = PartitionLayout(random_map(rng), NUM_WIRES, DEGREE)
    witnesses = [PartitionWitness(layout, NUM_WIRES, DEGREE)
                 for _ in range(B)]
    for w in witnesses:
        fill(w, rng, rng.random())
    in_c = wire_matrix(witnesses)
    monkeypatch.setattr(host, "load", lambda: None)
    np.testing.assert_array_equal(wire_matrix(witnesses), in_c)
    np.testing.assert_array_equal(
        in_c, np.stack([dense_walk(w) for w in witnesses], axis=1))


def test_wire_values_counts_the_set_representatives():
    rng = np.random.default_rng(7)
    layout = PartitionLayout(random_map(rng), NUM_WIRES, DEGREE)
    witnesses = [PartitionWitness(layout, NUM_WIRES, DEGREE)
                 for _ in range(3)]
    for w in witnesses:
        fill(w, rng, 0.4)
    tree = TimingTree(enabled=True)
    with tree.scope("wire matrix"):
        wire_matrix(witnesses)
    set_count = sum(v is not None for w in witnesses for v in w.as_list())
    assert tree.counts == {"wire_values": set_count}
    assert set_count == sum(len(w.set_reps) for w in witnesses)
    assert all(len(set(w.set_reps)) == len(w.set_reps) for w in witnesses)


def test_layout_refuses_a_representative_out_of_range():
    rep = np.arange(NUM_WIRES * DEGREE + 1, dtype=np.int64)
    rep[3] = len(rep)
    with pytest.raises(ValueError):
        PartitionLayout(rep, NUM_WIRES, DEGREE)


def _fib_host():
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config(),
                             seed=1234)
    a, b = builder.add_virtual_target(), builder.add_virtual_target()
    prev, cur = a, b
    for _ in range(20):
        prev, cur = cur, builder.add(prev, cur)
    builder.register_public_input(cur)
    return builder.build_host(), a, b


def test_proofs_of_one_circuit_share_one_layout():
    """Two fixpoints of one circuit (as two proofs run them) read one
    representative list and one inverse map of the wire matrix, which
    neither changes; the witnesses' values and records are their own."""
    host, a, b = _fib_host()
    rep_before = host.representative_map.copy()
    witnesses = []
    for x in (0, 5):
        pw = PartialWitness()
        pw.set_target(a, x)
        pw.set_target(b, 1)
        witnesses.append(generate_partial_witness(pw, host, host.common))
    first, second = witnesses
    layout = PartitionLayout.of(host, host.common)
    assert first.layout is second.layout is layout
    assert first.rep_list is second.rep_list is layout.rep_list
    assert first.values is not second.values
    assert first.set_reps is not second.set_reps
    assert not layout.rep_slots.flags.writeable
    assert not layout.rep_starts.flags.writeable
    np.testing.assert_array_equal(host.representative_map, rep_before)
    assert layout.rep_list == tuple(rep_before.tolist())
    # the inverse map: each representative's slots of the [wires, rows]
    # matrix, in slot order
    n, w = host.common.degree, host.common.config.num_wires
    slot_reps = rep_before[: n * w].reshape(n, w).T.reshape(-1)
    owners = np.repeat(np.arange(len(rep_before)), np.diff(layout.rep_starts))
    np.testing.assert_array_equal(slot_reps[layout.rep_slots], owners)
    np.testing.assert_array_equal(np.sort(layout.rep_slots),
                                  np.arange(n * w))
    for witness in witnesses:
        np.testing.assert_array_equal(witness.full_witness(),
                                      dense_walk(witness))
    assert not np.array_equal(first.full_witness(), second.full_witness())
