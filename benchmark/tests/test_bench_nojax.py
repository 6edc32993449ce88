"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their top-level part, whole: plonky2_tpu_torch begins with plonky2_tpu."""

import ast
import os

import pytest

from benchmark import load

FORBIDDEN = {"jax", "jaxlib", "flax", "plonky2_tpu"}
# the reference may import the standard library, numpy, torch and itself
REFERENCE_MAY = {"numpy", "torch", "__future__", "dataclasses"}


def modules():
    for base, _, files in os.walk(load.ROOT):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(base, name)


def imports(path):
    """(top-level name, relative level) of each import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_the_walk_sees_every_part():
    rel = {os.path.relpath(p, load.ROOT) for p in modules()}
    assert {"run.py", "reference/plonk.py", "metrics/fri.open_ms.py",
            "roofline/ntt.py", "configs/starky_fib_r20.py"} <= rel


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, load.ROOT))
def test_no_jax(path):
    found = {name for name, _ in imports(path)} & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", [p for p in modules() if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, load.ROOT))
def test_reference_stands_alone(path):
    for name, level in imports(path):
        assert name != "plonky2_tpu_torch", f"{path} imports the program"
        assert level <= 1, f"{path} imports from outside reference/"
        if level == 0:
            assert name in REFERENCE_MAY, f"{path} imports {name}"


def test_the_check_compares_whole_names():
    assert "plonky2_tpu_torch" not in FORBIDDEN
    assert "plonky2_tpu_torch".split(".")[0] != "plonky2_tpu"
