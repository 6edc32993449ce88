"""Finds the benchmark's files by name: `<kind>/<name>.json` for data and
`<kind>/<name>.py` for code, under this directory."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def path(kind: str, name: str, ext: str) -> str:
    p = os.path.join(ROOT, kind, name + ext)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {p}")
    return p


def data(kind: str, name: str) -> dict:
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The module of `<kind>/<name>.py`, loaded once."""
    key = f"benchmark.{kind}.{name.replace('.', '__')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path(kind, name,
                                                            ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_json() -> dict:
    with open(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")) as f:
        return json.load(f)
