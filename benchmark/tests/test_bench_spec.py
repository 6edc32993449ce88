"""BENCHMARK.json against the contract's form, every file found by name,
the roofline arithmetic, and the command's refusal without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import load
from benchmark.roofline import peaks

REPO = os.path.dirname(load.ROOT)
SPEC = load.benchmark_json()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.fullmatch(entry["name"])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["reduced"] == json.load(open(os.path.join(
            REPO, c["file"])))["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(SPEC["workloads"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    data = load.data("cells", cell)
    assert (data["config"], data["traffic"], data["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    load.path("configs", data["config"], ".json")
    assert hasattr(load.module("configs", data["config"]), "System")
    assert hasattr(load.module("reference", data["config"]), "check")
    load.data("traffic", data["traffic"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(load.module("metrics", metric).read)


def test_extra_cell_found_without_code_edit():
    from benchmark.run import metric_specs
    name = "recursion_leaf_d14.test_extra"
    path = os.path.join(load.ROOT, "cells", name + ".json")
    with open(path, "w") as f:
        json.dump({"config": "recursion_leaf_d14", "traffic": "batch4",
                   "chips": 1, "check_calls": 1}, f)
    try:
        assert load.data("cells", name)["traffic"] == "batch4"
        # metrics that list no cells would be read in it; these list theirs
        assert metric_specs(name, True) == []
        assert [m["name"] for m in metric_specs(name, False)] == [
            m["name"] for m in SPEC["end_to_end"]]
    finally:
        os.remove(path)


def test_roofline_bounds_at_the_recorded_shapes():
    """K1 [135, 2^14 -> 2^17] 0.04754 ms by bytes; K3 L=135, N=2^17 0.2515
    ms by operations (PERF.md's table of kernels)."""
    ntt = load.module("roofline", "ntt")
    leaves = load.module("roofline", "poseidon_hash_leaves")
    s, by = peaks.least_seconds(*ntt.work((135, 14, 3, "forward", 7)))
    assert by == "bytes" and round(s * 1e3, 5) == 0.04754
    s, by = peaks.least_seconds(*leaves.work((135, 1 << 17)))
    assert by == "operations" and round(s * 1e3, 4) == 0.2515


def test_roofline_names_match_the_profilers_kernel_names():
    ntt = load.module("roofline", "ntt")
    leaves = load.module("roofline", "poseidon_hash_leaves")
    assert re.search(ntt.TRACE_NAMES, "void (anonymous namespace)::"
                     "ntt_tiles(Args)")
    assert re.search(leaves.TRACE_NAMES, "void (anonymous namespace)::"
                     "hash_leaves_kernel<(anonymous namespace)::Poseidon>("
                     "unsigned long const*, unsigned long*, int, long long)")
    assert not re.search(leaves.TRACE_NAMES, "hash_leaves_kernel<"
                         "(anonymous namespace)::Poseidon2>(...)")


def test_command_fails_without_a_card(no_card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "recursion_leaf_d14.serial", "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
