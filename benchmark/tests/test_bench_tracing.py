"""The readers of the program's spans and counts (`metrics/fri.commit_phase_ms`,
`fri.query_rounds_ms`, `plonk.gate_constraints_ms`, `host_reads_per_proof`)
on traced runs of the harness, on the CPU at small sizes: each reads a
positive number in every cell that BENCHMARK.json lists for it, and the
reads a proof repeat from seed to seed."""

import pytest
import torch

from benchmark import load
from benchmark.run import run_cell
from plonky2_tpu_torch.utils import timing

SMALL = {"recursion_leaf_d14": {"degree_bits": 6},
         "starky_fib_r20": {"degree_bits": 8}}
NEW = ("fri.commit_phase_ms", "fri.query_rounds_ms",
       "plonk.gate_constraints_ms", "host_reads_per_proof")
SEEDS = (2 ** 31 + 4099, 2 ** 33 + 17)


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def traced(cell: str, seed: int, monkeypatch) -> dict:
    """One traced run, the process's counts started afresh (the command
    runs each cell in a process of its own)."""
    monkeypatch.setattr(timing, "_TOTALS", {})
    config = load.data("cells", cell)["config"]
    result, reasons = run_cell(cell, seed, 0.1, True, device="cpu",
                               config_patch=SMALL[config])
    assert result["correct"], reasons
    return result["metrics"]


def listed(cell: str) -> set:
    return {m["name"] for m in load.benchmark_json()["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load.benchmark_json()["workloads"]])
def test_new_readers_read_in_their_cells(cell, monkeypatch):
    metrics = traced(cell, SEEDS[0], monkeypatch)
    want = listed(cell)
    assert want and want <= set(metrics)
    for name in want:
        assert metrics[name]["value"] > 0, name
    assert not (set(NEW) - want) & set(metrics)


def test_host_reads_repeat_on_another_seed(monkeypatch):
    cell = "recursion_leaf_d14.serial"
    first, second = (traced(cell, seed, monkeypatch)["host_reads_per_proof"]
                     for seed in SEEDS)
    assert first["value"] == second["value"]
    assert first["unit"] == "reads"
