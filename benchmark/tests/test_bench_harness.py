"""The harness driven past its look for a card, on the CPU at small
sizes: sound runs come out correct; the control and each fault that a cell
can have, planted under the timed path, come out not correct. On a card,
the command itself for each cell."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import load
from benchmark.run import run_cell

SMALL = {"recursion_leaf_d14": {"degree_bits": 6},
         "starky_fib_r20": {"degree_bits": 8}}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def run(cell, trace=False, **kw):
    config = load.data("cells", cell)["config"]
    result, reasons = run_cell(cell, SEED, 0.1, trace, device="cpu",
                               config_patch=SMALL[config], **kw)
    json.dumps(result)
    return result, reasons


@pytest.mark.parametrize("cell", ["recursion_leaf_d14.serial",
                                  "starky_fib_r20.serial"])
def test_sound_run_is_correct(cell):
    result, reasons = run(cell)
    assert result["correct"], reasons
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"proofs_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["recursion_leaf_d14.serial",
                                  "starky_fib_r20.serial"])
def test_control_is_not_correct(cell):
    config = load.data("cells", cell)["config"]
    result, reasons = run(cell, program_patch=load.module(
        "reference", config).CONTROL)
    assert not result["correct"]
    assert result["checks"]["refused"]["value"] >= 1
    assert "proof of work" in reasons[0]


def _replay_first(prove):
    """A step that returns its state unchanged: every call gets the proofs
    of the first call."""
    first = []

    def faulty(prepared, timing):
        if not first:
            first.extend(prove(prepared, timing))
        return list(first[:len(prepared)])
    return faulty


def _half_batch(prove):
    """Half of the batch left out: the first half proved, and its proofs
    returned in the places of the rest."""
    def faulty(prepared, timing):
        half = prove(prepared[:max(1, len(prepared) // 2)], timing)
        return (half * len(prepared))[:len(prepared)]
    return faulty


def _altered_answer(prove):
    """An answer altered where it is produced: one opened value of each
    proof off by one."""
    def faulty(prepared, timing):
        proofs = prove(prepared, timing)
        for p in proofs:
            o = p.proof.openings
            values = getattr(o, "wires", None) or o.local_values
            values[0] = ((values[0][0] + 1) % ((1 << 64) - (1 << 32) + 1),
                         values[0][1])
        return proofs
    return faulty


@pytest.mark.parametrize("cell,fault", [
    ("recursion_leaf_d14.serial", _replay_first),
    ("starky_fib_r20.serial", _replay_first),
    ("recursion_leaf_d14.batch4", _half_batch),
    ("recursion_leaf_d14.batch4", _altered_answer),
    ("starky_fib_r20.serial", _altered_answer),
], ids=["leaf-unchanged", "fib-unchanged", "batch-half", "batch-altered",
        "fib-altered"])
def test_fault_is_not_correct(cell, fault):
    result, reasons = run(cell, fault=fault)
    assert not result["correct"]


def test_traced_run_reads_the_scopes():
    result, reasons = run("recursion_leaf_d14.batch4", trace=True)
    assert result["correct"], reasons
    assert {"plonk.quotient_ms", "plonk.partial_products_ms",
            "fri.open_ms"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load.benchmark_json()["workloads"]])
def test_command_on_the_card(card, cell):
    repo = os.path.dirname(load.ROOT)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=repo,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
