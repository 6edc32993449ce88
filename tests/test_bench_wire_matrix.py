"""The benchmark's readers of the PLONK wire matrix
(`benchmark/metrics/plonk.wire_matrix_ms.py`, `plonk.wire_values_per_proof.py`)
on synthetic contexts: each reads its span or count a proof, and None where
the program opens no such span or keeps no such count."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import load  # noqa: E402
from benchmark.run import Context  # noqa: E402
from plonky2_tpu_torch.utils import timing  # noqa: E402

MS = load.module("metrics", "plonk.wire_matrix_ms")
VALUES = load.module("metrics", "plonk.wire_values_per_proof")


def context(scopes, per_call=1):
    return Context(scopes=scopes, proofs_per_call=per_call)


def test_wire_matrix_ms_a_proof():
    serial = [{"run generators": 0.5, "witness upload": 0.02,
               "wire matrix": 0.004},
              {"run generators": 0.5, "witness upload": 0.03,
               "wire matrix": 0.006}]
    assert MS.read(context(serial)) == pytest.approx(5.0)
    batch = [{"run generators (batch)": 2.0, "wire matrix": 0.016}]
    assert MS.read(context(batch, per_call=4)) == pytest.approx(4.0)
    # calls of another prover (a STARK's) are not read
    stark = {"trace to device": 0.03, "wire matrix": 1.0}
    assert MS.read(context(serial + [stark])) == pytest.approx(5.0)


def test_wire_matrix_ms_none_without_the_span():
    parent = [{"run generators": 0.5, "witness upload": 0.4}]
    assert MS.read(context(parent)) is None
    assert MS.read(context([])) is None


def test_wire_values_a_proof(monkeypatch):
    monkeypatch.setattr(timing, "_TOTALS", {"proofs": 4, "wire_values": 1000,
                                            "host_reads": 288})
    assert VALUES.read(context([])) == 250


@pytest.mark.parametrize("totals", [{"proofs": 4, "host_reads": 288}, {},
                                    {"proofs": 0, "wire_values": 0}])
def test_wire_values_none_without_the_count(monkeypatch, totals):
    monkeypatch.setattr(timing, "_TOTALS", totals)
    assert VALUES.read(context([])) is None


def test_wire_values_none_without_totals(monkeypatch):
    monkeypatch.delattr(timing, "totals")
    assert VALUES.read(context([])) is None


def test_listed_in_the_plonk_cells():
    spec = load.benchmark_json()
    cells = ["recursion_leaf_d14.serial", "recursion_leaf_d14.batch4",
             "recursion_wrap_d13.serial"]
    for name, source in (("plonk.wire_matrix_ms", "program_span"),
                         ("plonk.wire_values_per_proof", "program_counter")):
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert (m["workloads"], m["source"], m["moves"]) == (
            cells, source, "proofs_per_s")
