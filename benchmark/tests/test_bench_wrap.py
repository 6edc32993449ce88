"""The recursion_wrap_d13 configuration and its cell: every file found by
name; on the CPU at a small size (the leaf at 2^6 with one FRI query, the
wrap at 2^11, whose key is tests/golden/wrap_small.json's), a planted fault
under the timed path reads wrong_inputs; on a card, the reference's own
commitment of the wrap's layout gives the pinned key, and the cell's traced
run is correct and reads its three metrics."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import load
from benchmark.run import run_cell

CELL = "recursion_wrap_d13.serial"
CONFIG = "recursion_wrap_d13"
METRICS = ("witness.generator_passes_ms", "witness.generator_index_ms",
           "witness.generator_runs_per_proof")
REPO = os.path.dirname(load.ROOT)
SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def test_files_found_by_name():
    spec = load.benchmark_json()
    cell = load.data("cells", CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "serial", 1)
    entry = next(c for c in spec["configs"] if c["name"] == CONFIG)
    cfg = load.data("configs", CONFIG)
    assert entry["reduced"] == cfg["reduced"] == ["num_public_inputs"]
    assert cfg["inner"] == "recursion_leaf_d14"
    load.data("configs", cfg["inner"])
    assert hasattr(load.module("configs", CONFIG), "System")
    reference = load.module("reference", CONFIG)
    assert callable(reference.check)
    assert reference.CONTROL == {"fri": {"proof_of_work_bits": 0}}
    load.data("traffic", cell["traffic"])
    for name in METRICS:
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL]
        assert callable(load.module("metrics", name).read)


def test_config_is_its_own_deployment():
    """The wrap names its own part of bench_recursion.rs: no configuration
    shares both its source and its reduced keys, and the file and the
    entry agree on the source."""
    spec = load.benchmark_json()
    entry = next(c for c in spec["configs"] if c["name"] == CONFIG)
    assert entry["source"] == load.data("configs", CONFIG)["source"]
    assert "recursive_proof" in entry["source"]
    for other in spec["configs"]:
        if other["name"] != CONFIG:
            assert (other["source"], sorted(other["reduced"])) != (
                entry["source"], sorted(entry["reduced"]))


def _small_patch() -> dict:
    with open(os.path.join(REPO, "tests", "golden", "wrap_small.json")) as f:
        golden = json.load(f)
    return {"inner_config": {"degree_bits": 6,
                             "fri": {"num_query_rounds": 1}},
            "degree_bits": 11, "gates": golden["gates"],
            "selector_groups": golden["selector_groups"],
            "verifier_key": golden["verifier_key"]}


def _replay_first(prove):
    """Every call answered with the first call's proof."""
    first = []

    def faulty(prepared, timing):
        if not first:
            first.extend(prove(prepared, timing))
        return list(first[:len(prepared)])
    return faulty


def test_replayed_proof_reads_wrong_inputs():
    result, reasons = run_cell(CELL, SEED, 0.1, False, device="cpu",
                               config_patch=_small_patch(),
                               fault=_replay_first)
    assert not result["correct"]
    assert result["checks"]["wrong_inputs"]["value"] >= 1


@pytest.mark.card
def test_reference_commitment_gives_the_pinned_key(card):
    from benchmark.reference import plain_torch
    from benchmark.reference.plonk import circuit_digest
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.recursion.verifier import wrap_circuit
    leaf_module = load.module("configs", "recursion_leaf_d14")
    cfg = load.data("configs", CONFIG)
    inner = cfg["inner_config"]
    builder = CircuitBuilder(leaf_module.circuit_config(inner))
    builder.register_public_inputs(
        builder.add_virtual_targets(inner["num_public_inputs"]))
    leaf = builder.build_host(min_degree_bits=inner["degree_bits"])

    class Inner:
        common = leaf.common
    wrap, _ = wrap_circuit(Inner, register_inner=True,
                           config=leaf_module.circuit_config(cfg))
    host = wrap.build_host(min_degree_bits=cfg["degree_bits"])
    cap = plain_torch.commitment_cap(host.constants_sigmas,
                                     cfg["fri"]["rate_bits"],
                                     cfg["fri"]["cap_height"], "cuda")
    key = cfg["verifier_key"]
    assert [list(d) for d in cap] == key["constants_sigmas_cap"]
    assert list(circuit_digest(cap, cfg["degree_bits"])) == \
        key["circuit_digest"]


@pytest.mark.card
def test_traced_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "3", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert set(METRICS) <= set(result["metrics"])
    assert result["metrics"]["witness.generator_runs_per_proof"]["value"] \
        >= 13022
