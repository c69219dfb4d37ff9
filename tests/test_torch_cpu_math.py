"""The package's guard for torch's first multi-threaded CPU sqrt/log
(hybridquantization_tpu_torch/cpu_math.py): in fresh processes at two
intra-op threads, the first call after importing the package equals the
second. Unguarded, a few percent of such processes had one thread's chunk
of 2048 elements up to ~4e-4 relative off on the first call, so these four
processes would mostly pass without the guard too: this is a smoke test of
the import path. The check that would catch a regression is
`python -m hybridquantization_tpu_torch.tools.cpu_math_check` (200 fresh
processes per case, 8 at a time, at 2 and 8 threads)."""

import subprocess
import sys

import pytest
import torch

from hybridquantization_tpu_torch import cpu_math

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

FIRST_CALL = """
import numpy as np, torch
torch.set_num_threads(2)
import hybridquantization_tpu_torch  # noqa: F401  (the guard runs here)
x = torch.from_numpy(np.random.default_rng(0).random(4096, dtype=np.float32) + 0.5)
for name, fn in (("sqrt", torch.sqrt), ("log", torch.log), ("pow", lambda t: torch.pow(t, 0.5))):
    y = x + 0.0  # a fresh tensor for each op
    assert torch.equal(fn(y), fn(y)), name
print("ok")
"""


def test_first_parallel_calls_equal_second_in_fresh_processes():
    procs = [
        subprocess.Popen([sys.executable, "-c", FIRST_CALL], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip().endswith("ok") for o in outs), outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warm_up_again_leaves_results_alone(dtype):
    x = torch.linspace(0.5, 4.0, 5000, dtype=dtype)
    before = torch.sqrt(x), torch.log(x)
    cpu_math.warm_up()
    cpu_math.warm_up()
    assert torch.equal(torch.sqrt(x), before[0]) and torch.equal(torch.log(x), before[1])
