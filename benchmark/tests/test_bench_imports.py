"""What the benchmark's modules import, by top-level name compared whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "hybridquantization_tpu"}
PORT = "hybridquantization_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules(sub: str = "") -> list[Path]:
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", modules("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)
    assert not {"benchmark"} & top_level_imports(path)  # relative imports within reference/ only


def test_a_run_imports_the_program_through_jobs_only():
    # readings.py plants a fault in the program with --stuck; the tests compare with it
    users = {p.relative_to(BENCH).as_posix() for p in modules() if PORT in top_level_imports(p)}
    assert users <= {"jobs.py", "readings.py"} | {p.relative_to(BENCH).as_posix() for p in modules("tests")}


def test_the_port_name_is_not_taken_for_the_jax_package():
    # the check compares whole names: the port's name begins with the JAX package's
    assert PORT.split(".")[0] not in JAX_SIDE
    assert "hybridquantization_tpu" in JAX_SIDE
