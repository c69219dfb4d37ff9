"""On a card: a short run of each cell comes out correct, and prints the
contract's result line. Skipped without a card.

    python -m pytest benchmark/tests -q -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import cells

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (cells.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_short_run_is_correct(cuda_device, name):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 3),
         "--seconds", "12", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=900, check=True,
    ).stdout.strip().splitlines()[-1]
    result = json.loads(out)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
