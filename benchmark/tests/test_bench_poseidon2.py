"""The recursion_leaf_d14_poseidon2 configuration and its cell: every file
found by name; on the CPU at a small size (the leaf at 2^6), a sound run is
correct and reads `merkle.trees_ms` traced, and the control is not correct;
the rooflines of K7 and of K6's tree entry at the shapes PERF.md's table of
kernels records, and their names against the profiler's; on a card, the
cell's traced run is correct and reads its three metrics."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import load
from benchmark.roofline import peaks
from benchmark.run import run_cell
from plonky2_tpu_torch.utils import timing

CELL = "recursion_leaf_d14_poseidon2.serial"
CONFIG = "recursion_leaf_d14_poseidon2"
METRICS = ("merkle.trees_ms", "poseidon2_hash_leaves_roofline",
           "poseidon2_merkle_tree_roofline")
REPO = os.path.dirname(load.ROOT)
SMALL = {"degree_bits": 6}
SEED = 2 ** 31 + 25


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
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"] == ["num_public_inputs"]
    assert cfg["hasher"] == "Poseidon2GoldilocksConfig"
    leaf = load.data("configs", "recursion_leaf_d14")
    assert {k for k in leaf if leaf[k] != cfg[k]} == {
        "name", "source", "describes", "hasher", "guarantees", "assumed"}
    program = load.module("configs", CONFIG)
    assert program.System is load.module("configs",
                                         "recursion_leaf_d14").System
    reference = load.module("reference", CONFIG)
    assert callable(reference.check)
    assert reference.CONTROL == {"fri": {"proof_of_work_bits": 0}}
    load.data("traffic", cell["traffic"])
    for name in METRICS:
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert CELL in m["workloads"] and m["moves"] == "proofs_per_s"
        assert callable(load.module("metrics", name).read)


def run(trace=False, cell=CELL, **kw):
    result, reasons = run_cell(cell, SEED, 0.1, trace, device="cpu",
                               config_patch=SMALL, **kw)
    json.dumps(result)
    return result, reasons


def test_sound_run_is_correct():
    result, reasons = run()
    assert result["correct"], reasons
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"proofs_per_s", "setup_s"}


def test_control_is_not_correct():
    result, reasons = run(program_patch=load.module(
        "reference", CONFIG).CONTROL)
    assert not result["correct"]
    assert result["checks"]["refused"]["value"] >= 1
    assert "proof of work" in reasons[0]


@pytest.mark.parametrize("cell", [CELL, "recursion_leaf_d14.serial"])
def test_traced_run_reads_the_trees(cell, monkeypatch):
    """`merkle.trees_ms` under both hashers; the rooflines read nothing on
    the CPU, which launches no kernel."""
    monkeypatch.setattr(timing, "_TOTALS", {})
    result, reasons = run(trace=True, cell=cell)
    assert result["correct"], reasons
    assert result["metrics"]["merkle.trees_ms"]["value"] > 0
    assert not {"poseidon2_hash_leaves_roofline",
                "poseidon2_merkle_tree_roofline"} & set(result["metrics"])


def test_roofline_bounds_at_the_recorded_shapes():
    """K7 L=135, N=2^17 0.3922 ms and K6's tree 2^17 leaves at cap 4
    0.02307 ms, both by operations (PERF.md's table of kernels): 736 field
    multiplies a permutation, 736/472 of K3's and K2's."""
    leaves = load.module("roofline", "poseidon2_hash_leaves")
    tree = load.module("roofline", "poseidon2_merkle_tree")
    s, by = peaks.least_seconds(*leaves.work((135, 1 << 17)))
    assert by == "operations" and round(s * 1e3, 4) == 0.3922
    s, by = peaks.least_seconds(*tree.work((1 << 17, 4)))
    assert by == "operations" and round(s * 1e3, 5) == 0.02307
    assert leaves.FIELD_MULS_PER_PERMUTATION == 736
    assert tree.work((1 << 17, 4))[0] == 32 * ((1 << 18) - 16)


def test_roofline_names_match_the_profilers_kernel_names():
    leaves = load.module("roofline", "poseidon2_hash_leaves")
    tree = load.module("roofline", "poseidon2_merkle_tree")
    k3 = load.module("roofline", "poseidon_hash_leaves")
    ns = "(anonymous namespace)::"
    args = "(unsigned long const*, unsigned long*, int, long long)"
    for kernel in ("hash_leaves_kernel", "hash_leaves_lanes_kernel"):
        p2 = f"void {ns}{kernel}<{ns}Poseidon2>{args}"
        p1 = f"void {ns}{kernel}<{ns}Poseidon>{args}"
        assert re.search(leaves.TRACE_NAMES, p2)
        assert not re.search(leaves.TRACE_NAMES, p1)
        assert re.search(k3.TRACE_NAMES, p1)
        assert not re.search(k3.TRACE_NAMES, p2)
    tree_args = ("(unsigned long const*, unsigned long*, long long, int, "
                 "int, int)")
    assert re.search(tree.TRACE_NAMES,
                     f"void {ns}merkle_kernel<{ns}Poseidon2>{tree_args}")
    assert not re.search(tree.TRACE_NAMES,
                         f"void {ns}merkle_kernel<{ns}Poseidon>{tree_args}")
    assert not re.search(tree.TRACE_NAMES,
                         f"void {ns}permute_kernel<{ns}Poseidon2>(...)")


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
    for name in METRICS[1:]:
        assert 0 < result["metrics"][name]["value"] <= 100
