"""What the benchmark's modules import: no JAX, no JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""
import ast
import sys
import types

import pytest

from port_bench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    """Top-level names of every module the file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE / "reference")))
def test_reference_is_apart_from_the_program(path):
    assert "repro_torch" not in imported(path)
    # and no file of the benchmark outside the reference
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.startswith("port_bench.reference") or \
                node.module.split(".")[0] != "port_bench"


def test_whole_names():
    """`repro_torch` is the port, not the JAX package."""
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_forbidden_modules_are_found(monkeypatch):
    """The run's own check, on the process's modules."""
    from port_bench.runcell import forbidden_modules
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    found = forbidden_modules()
    assert {"jax", "repro"} <= set(found) and "repro_torch" not in found
