"""The prover's TimingTree scopes (plonk/prover.py) and the profiler capture
(utils/timing.py) of the port on the CPU: a port prove of fib(100) records
the JAX package's eight scope labels in the order the JAX prove records
them, the port's HOST_SPANS between them and the scopes inside round 3 and
FRI under their documented parents, with the same proof bytes as an
untimed prove and as the JAX prove; an enabled tree ends each scope in a
synchronize of a CUDA device and a disabled one in none, and a disabled
tree records nothing and never becomes the thread's active tree; every
span of a PLONK and a STARK prove lies inside its parent and under a
depth-0 scope, and on torch.profiler's clock within 2 ms of its range;
`host_reads` repeats from prove to prove, counts only the proving thread's
reads, and `proofs` counts a batch's proofs; PLONKY2_TPU_TIMING makes a
default prove print its scopes; PLONKY2_TPU_PROFILE makes a prove write a
Chrome trace that names every scope; fib proves at 0 and 1 bits of proof
of work and its proof verifies in the JAX package, whose grind takes the
port's witness from 1 bit on. The batch prover's labels are held against
JAX's in tests/test_torch_batch.py, where JAX's `prove_batch` already
runs."""

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import service_circuits as sc
import stark_circuits
import timing_labels as tl
from plonky2_tpu.fri import prover as jfri
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.plonk.prover import prove as jprove
from plonky2_tpu.plonk.verifier import verify as jverify
from plonky2_tpu.utils.serialization import (
    deserialize_proof_with_pis as jdeserialize,
    serialize_proof_with_pis as jserialize,
)
from plonky2_tpu.utils.timing import TimingTree as JTimingTree
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.fri import prover as fri_prover
from plonky2_tpu_torch.hash.hashers import POSEIDON
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.plonk import prover
from plonky2_tpu_torch.plonk.batch_prover import prove_batch
from plonky2_tpu_torch.starky.config import StarkConfig
from plonky2_tpu_torch.starky.prover import prove as stark_prove
from plonky2_tpu_torch.starky.verifier import verify_stark_proof
from plonky2_tpu_torch.utils import timing as timing_mod
from plonky2_tpu_torch.utils.serialization import serialize_proof_with_pis
from plonky2_tpu_torch.utils.timing import TimingTree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "plonky2_tpu_torch", "plonky2_tpu"
SEED = 1234
top_labels = tl.top


@pytest.fixture(scope="module")
def jax_timed():
    """JAX's fib(100) (seed 1234) proved under an enabled TimingTree: (its
    top-level scope labels in order, its proof bytes)."""
    builder, inputs = sc.fib(JAX, 99, seed=SEED)
    data = builder.build()
    tree = JTimingTree(enabled=True)
    proof = jprove(data.prover_only, data.common, inputs(0, 1), timing=tree)
    return [node[0] for node in tree.root[2]], jserialize(proof, data.common)


def port_proof(timing=None, common: list | None = None) -> bytes:
    builder, inputs = sc.fib(PORT, 99, seed=SEED)
    data = builder.build(device="cpu")
    proof = data.prove(inputs(0, 1), timing)
    data.verify(proof)
    if common is not None:
        common.append(data.common)
    return serialize_proof_with_pis(proof, data.common)


def serial_labels(common) -> tuple:
    """(depth-0 labels, nested labels) of a serial PLONK prove."""
    return (tl.plonk_top(prover.SERIAL_SCOPES, 1),
            tl.plonk_nested(common, prover.SERIAL_SCOPES, 1))


def test_serial_scopes_are_jax_s_labels_in_order(jax_timed):
    want, _ = jax_timed
    tree = TimingTree(enabled=True)
    common = []
    port_proof(tree, common)
    top, nested = serial_labels(common[0])
    assert [label for label in top_labels(tree)
            if label not in prover.HOST_SPANS] == want \
        == list(prover.SERIAL_SCOPES)
    assert top_labels(tree) == top
    assert tl.nested(tree) == nested
    assert all(dt >= 0 for _, _, dt in tree.records)
    assert set(tree.seconds()) == tl.labels(top, nested)


def test_timing_leaves_the_proof_bytes_unchanged(jax_timed):
    _, want = jax_timed
    timed = port_proof(TimingTree(enabled=True))
    assert timed == port_proof() == port_proof(TimingTree(enabled=False))
    assert timed == want


@pytest.mark.parametrize("enabled", [True, False])
def test_scope_synchronizes_the_device_only_when_enabled(monkeypatch,
                                                         enabled):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    cuda = torch.device("cuda", 0)
    tree = TimingTree(enabled=enabled)
    for label in ("a", "b"):
        with tree.scope(label, cuda):
            pass
    with tree.scope("c", torch.device("cpu")):
        pass
    with tree.scope("d"):
        pass
    assert synced == ([cuda, cuda] if enabled else [])


def test_timing_env_enables_the_default_tree(monkeypatch, capsys):
    monkeypatch.setenv("PLONKY2_TPU_TIMING", "1")
    assert TimingTree().enabled
    builder, inputs = sc.fib(PORT, 20, seed=SEED)
    data = builder.build(device="cpu")
    data.prove(inputs(0, 1))
    lines = [line[len("[timing] "):]
             for line in capsys.readouterr().out.splitlines()
             if line.startswith("[timing]")]
    # each line: two spaces a level, the milliseconds in 9, "ms", the label
    printed = [((len(line.split(" ms  ", 1)[0]) - 9) // 2,
                line.split(" ms  ", 1)[1]) for line in lines]
    tree = TimingTree(enabled=True)
    data.prove(inputs(0, 1), tree)
    assert printed == [(depth, label) for depth, label, _ in tree.records]
    top, nested = serial_labels(data.common)
    assert [label for depth, label in printed if depth == 0] == top
    assert [label for depth, label in printed if depth == 0
            and label not in prover.HOST_SPANS] == list(prover.SERIAL_SCOPES)
    assert tl.nested(tree) == nested
    monkeypatch.delenv("PLONKY2_TPU_TIMING")
    assert not TimingTree().enabled


PROFILE_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
sys.path.insert(0, "tests")
import torch
torch.set_num_threads(1)
import service_circuits as sc
from plonky2_tpu_torch.utils.timing import stop_profiler
builder, inputs = sc.fib("plonky2_tpu_torch", 3, seed=5, query_rounds=1)
data = builder.build(device="cpu")
data.verify(data.prove(inputs(0, 1)))
print("TRACE", stop_profiler())
print("AGAIN", stop_profiler())
"""


def test_profile_env_writes_a_trace_naming_every_scope(tmp_path):
    out = tmp_path / "trace"
    env = dict(os.environ, PYTHONPATH=ROOT, PLONKY2_TPU_PROFILE=str(out))
    env.pop("PLONKY2_TPU_TIMING", None)
    proc = subprocess.run([sys.executable, "-c", PROFILE_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("TRACE", "AGAIN")))
    assert lines["AGAIN"] == "None"
    path = lines["TRACE"]
    assert os.path.dirname(path) == str(out) and path.endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(prover.SERIAL_SCOPES) | set(prover.HOST_SPANS) \
        | set(tl.FRI_INSIDE) <= names


def test_no_capture_without_the_profile_env(monkeypatch):
    monkeypatch.delenv("PLONKY2_TPU_PROFILE", raising=False)
    TimingTree(enabled=True)
    assert timing_mod._PROFILE is None
    assert timing_mod.stop_profiler() is None


def small_fib(steps: int = 3, **config):
    """A fib circuit built on the CPU with one query round, its FRI config
    changed by `config`; -> (data, inputs)."""
    builder, inputs = sc.fib(PORT, steps, seed=5, query_rounds=1)
    if config:
        builder.config = dataclasses.replace(
            builder.config, fri_config=dataclasses.replace(
                builder.config.fri_config, **config))
    return builder.build(device="cpu"), inputs


def stark_fib():
    config = StarkConfig.standard_fast_config()
    stark, trace, pis = stark_circuits.fibonacci(PORT, 1 << 5)
    return config, stark, trace, pis


def check_nesting(tree: TimingTree) -> None:
    """Every span lies inside its parent, and the chain of parents ends at
    a depth-0 scope."""
    spans = {s.id: s for s in tree.spans}
    depth0 = {label for depth, label, _ in tree.records if depth == 0}
    assert len(spans) == len(tree.spans) == len(tree.records)
    for s in tree.spans:
        assert s.start_ns <= s.end_ns
        root = s
        while root.parent is not None:
            parent = spans[root.parent]
            assert parent.start_ns <= root.start_ns <= root.end_ns \
                <= parent.end_ns
            root = parent
        assert root.label in depth0


def test_spans_nest_under_depth0_scopes():
    data, inputs = small_fib()
    data.prove(inputs(0, 1))
    tree = TimingTree(enabled=True)
    data.verify(data.prove(inputs(0, 1), tree))
    check_nesting(tree)
    assert tl.nested(tree) == tl.plonk_nested(
        data.common, prover.SERIAL_SCOPES, 1)
    assert {s.b for s in tree.spans if s.label.startswith("FRI")} == {0}

    config, stark, trace, pis = stark_fib()
    tree = TimingTree(enabled=True)
    verify_stark_proof(stark, stark_prove(stark, config, trace, pis, tree,
                                          device="cpu"), config)
    check_nesting(tree)
    assert top_labels(tree) == list(tl.STARK_TOP)
    assert tl.nested(tree) == tl.stark_nested(config.fri_params(5))
    assert tree.counts["proofs"] == 1


def _kineto_ns(e) -> tuple[int, int]:
    start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
    dur = (e.duration_ns() if hasattr(e, "duration_ns")
           else 1000 * e.duration_us())
    return start, start + dur


def _clock_offsets(data, inputs) -> list:
    """One prove under an enabled tree and a torch.profiler capture: each
    span's (label, start offset, end offset) in ns from its
    record_function range, matched label by label in order."""
    tree = TimingTree(enabled=True)
    threads = torch.get_num_threads()
    gc.disable()        # a collection inside a scope is no clock's offset
    torch.set_num_threads(1)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            data.prove(inputs(0, 1), tree)
    finally:
        torch.set_num_threads(threads)
        gc.enable()
    labels = {s.label for s in tree.spans}
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in labels:
            ranges.setdefault(e.name(), []).append(_kineto_ns(e))
    offsets = []
    for label in labels:
        spans = sorted((s.start_ns, s.end_ns) for s in tree.spans
                       if s.label == label)
        got = sorted(ranges[label])
        assert len(got) == len(spans), label
        offsets += [(label, s0 - r0, s1 - r1)
                    for (s0, s1), (r0, r1) in zip(spans, got)]
    return offsets


def test_spans_lie_on_the_profiler_clock():
    """Every span's start and end lie within 2 ms of its record_function
    range. A span on another clock is off in every capture, by hours for
    `time.monotonic_ns()`, so the median offset is held in each capture;
    a thread the host takes off its core between a span's stamp and its
    range's can be a few ms late in one capture, so each span is held in
    at least one of three."""
    data, inputs = small_fib()
    data.prove(inputs(0, 1))
    worst = []
    for _ in range(3):
        offsets = _clock_offsets(data, inputs)
        assert abs(statistics.median(
            d for _, s0, s1 in offsets for d in (s0, s1))) < 2_000_000
        worst.append(max(offsets, key=lambda o: max(abs(o[1]), abs(o[2]))))
        if max(abs(worst[-1][1]), abs(worst[-1][2])) < 2_000_000:
            break
    else:
        pytest.fail(f"a span off its range by 2 ms or more in each of "
                    f"three captures: {worst}")


def test_disabled_tree_records_nothing_and_is_never_active(monkeypatch):
    data, inputs = small_fib()
    seen = []
    count = timing_mod.count
    monkeypatch.setattr(timing_mod, "count", lambda name, n=1: (
        seen.append(timing_mod._ACTIVE.tree), count(name, n)))
    before = timing_mod.totals()
    tree = TimingTree(enabled=False)
    data.verify(data.prove(inputs(0, 1), tree))
    assert seen and set(seen) == {None}
    assert tree.spans == [] and tree.counts == {} \
        and tree.span_counts == {} and tree.records == []
    assert timing_mod.totals() == before


def host_reads(data, inputs) -> TimingTree:
    tree = TimingTree(enabled=True)
    data.prove(inputs(0, 1), tree)
    return tree


def test_host_reads_repeat_and_lie_in_fri():
    data, inputs = small_fib(20)
    data.prove(inputs(0, 1))                # lazy tables made here
    before = timing_mod.totals()
    first, second = host_reads(data, inputs), host_reads(data, inputs)
    assert first.counts == second.counts
    assert first.span_counts == second.span_counts
    assert first.counts["proofs"] == 1 and first.counts["host_reads"] > 0
    for label in ("FRI query rounds",
                  "fold codewords in the commitment phase"):
        assert first.span_counts[label]["host_reads"] > 0
    assert sum(c.get("host_reads", 0)
               for c in first.span_counts.values()) == \
        first.counts["host_reads"]
    after = timing_mod.totals()
    assert after["host_reads"] - before.get("host_reads", 0) == \
        2 * first.counts["host_reads"]
    assert after["proofs"] - before.get("proofs", 0) == 2


def test_reads_of_another_thread_are_not_counted():
    data, inputs = small_fib(20)
    data.prove(inputs(0, 1))
    alone = host_reads(data, inputs).counts
    stop, reads = threading.Event(), []

    def reader():
        t = torch.arange(16)
        while not stop.is_set():
            gl.to_u64(t)
            gl.from_u64(np.arange(4, dtype=np.uint64), "cpu")
            reads.append(1)
    thread = threading.Thread(target=reader)
    thread.start()
    try:
        beside = host_reads(data, inputs).counts
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and reads
    assert beside == alone


def test_proofs_counts_a_batch():
    data, inputs = small_fib()
    tree = TimingTree(enabled=True)
    proofs = prove_batch(data.prover_only, data.common,
                         [inputs(0, 1), inputs(2, 3)], tree)
    for p in proofs:
        data.verify(p)
    assert tree.counts["proofs"] == 2
    check_nesting(tree)
    assert {s.b for s in tree.spans if s.b is not None} == {0, 1}


def jax_small_fib(steps: int, **config):
    """JAX's data of `small_fib(steps, **config)`'s circuit."""
    builder, _ = sc.fib(JAX, steps, seed=5, query_rounds=1)
    builder.config = dataclasses.replace(
        builder.config, fri_config=dataclasses.replace(
            builder.config.fri_config, **config))
    return builder.build()


@pytest.mark.parametrize("bits", [0, 1])
def test_fib_proves_at_few_pow_bits(bits):
    """The port proves fib at 0 and 1 bit of proof of work; its proof
    verifies in the port and, from its bytes, in the JAX package."""
    data, inputs = small_fib(20, proof_of_work_bits=bits)
    assert data.common.config.fri_config.proof_of_work_bits == bits
    proof = data.prove(inputs(0, 1))
    data.verify(proof)
    witness = proof.proof.opening_proof.pow_witness
    assert witness == 0 if bits == 0 else witness >= 0
    jdata = jax_small_fib(20, proof_of_work_bits=bits)
    jproof = jdeserialize(serialize_proof_with_pis(proof, data.common),
                          jdata.common)
    jverify(jproof, jdata.verifier_only, jdata.common)


@pytest.mark.parametrize("bits", [0, 1, 2, 8])
def test_pow_wave_and_host_grind_agree(bits):
    """The wave's test on the int64 pattern and the host grind's on uint64
    find the same smallest witness (the wave's permutation here is the
    hasher's plain version on CPU tensors), and from 1 bit on it is the
    JAX grind's witness for the same transcript; at 0 bits it is 0."""
    ours, theirs = Challenger(POSEIDON), JChallenger()
    for x in range(11):
        ours.observe_element(7 * x + 3)
        theirs.observe_element(7 * x + 3)
    state = list(ours.sponge_state)
    pos = len(ours.input_buffer)
    state[:pos] = ours.input_buffer
    wave = fri_prover._pow_wave(POSEIDON.permute, state, pos, bits, 256,
                                "cpu")
    host = fri_prover._pow_grind_host(POSEIDON.permute_many_host, state,
                                      pos, bits, 256)
    assert wave == host
    if bits:
        assert host == jfri.fri_proof_of_work(theirs, bits, batch=256)
    else:
        assert host == 0
