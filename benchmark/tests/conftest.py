"""Benchmark tests: CPU tests at small sizes, and a `cuda` marker for the
ones that need a card, which skip from the `cuda_device` fixture without one.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped from a fixture without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


#: small image sets and schedules, per configuration and traffic mix, for CPU runs
TINY_IMAGES = {
    "single": [{"height": 40, "width": 56, "count": 2}],
    "batch": [{"height": 32, "width": 40, "count": 2}, {"height": 24, "width": 32, "count": 3}],
}
TINY_TRAFFIC = {"colors": 8, "imax": 4, "polish": 2, "trace_jobs": 2}


def tiny_root(tmp: Path, imax_plugin: int = 40) -> Path:
    """A checkout-like tree with the repo's BENCHMARK.json and benchmark/,
    its configurations and mixes cut to CPU size; limits as committed."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["images"] = TINY_IMAGES[cfg["engine_kind"]]
        path.write_text(json.dumps(cfg))
    for path in (tmp / "benchmark" / "workloads").glob("*.json"):
        t = json.loads(path.read_text())
        if t["imax"] > 100:
            t.update(imax=imax_plugin)
        else:
            t.update(TINY_TRAFFIC)
        path.write_text(json.dumps(t))
    return tmp
