"""Count fresh processes whose first multi-threaded CPU sqrt/log is wrong.

    python -m hybridquantization_tpu_torch.tools.cpu_math_check \
        [--procs 200] [--parallel 8] [--threads 2,8] [--ops sqrt,log,pow] \
        [--guard none,import,import_then_threads]

Each process sets torch's intra-op threads, applies the op to 4096 floats
(2 threads) or 2^20 floats (more threads) twice, and reports whether the
first result differs from the second. Guards: "none" (torch alone, the
fault), "import" (the package imported after setting the threads, as a
program that imports it does: cpu_math.warm_up), "import_then_threads" (the
package imported at 2 threads, then the threads set: a later
torch.set_num_threads). Prints one line per (guard, threads, op) and one
JSON object last. The processes run `--parallel` at a time: the fault shows
more often on a busy host.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]

CHILD = """
import os, sys
sys.path.insert(0, {root!r})
threads, op, guard = {threads}, {op!r}, {guard!r}
import numpy as np, torch
if guard == "import_then_threads":
    torch.set_num_threads(2)
    import hybridquantization_tpu_torch  # noqa: F401
torch.set_num_threads(threads)
if guard == "import":
    import hybridquantization_tpu_torch  # noqa: F401
n = 4096 if threads == 2 else 1 << 20
x = torch.from_numpy(np.random.default_rng(0).random(n, dtype=np.float32) + 0.5)
fn = {{"sqrt": torch.sqrt, "log": torch.log, "pow": lambda t: torch.pow(t, 0.5)}}[op]
a, b = fn(x), fn(x)
bad = a != b
print(int(bad.sum()), float(((a - b).abs() / b.abs()).max()))
"""


def _one(threads: int, op: str, guard: str) -> tuple[int, float]:
    code = CHILD.format(root=str(_ROOT), threads=threads, op=op, guard=guard)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    n, rel = out.stdout.split()
    return int(n), float(rel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--threads", default="2,8")
    ap.add_argument("--ops", default="sqrt,log,pow")
    ap.add_argument("--guard", default="none,import,import_then_threads")
    args = ap.parse_args(argv)
    res = {}
    with ThreadPoolExecutor(args.parallel) as ex:
        for guard in args.guard.split(","):
            for threads in map(int, args.threads.split(",")):
                if guard == "import_then_threads" and threads == 2:
                    continue
                for op in args.ops.split(","):
                    runs = list(ex.map(lambda _: _one(threads, op, guard), range(args.procs)))
                    bad = [r for r in runs if r[0]]
                    key = f"{guard} threads={threads} {op}"
                    res[key] = {"procs": len(runs), "wrong": len(bad),
                                "elements": sorted({r[0] for r in bad}),
                                "max_rel": max((r[1] for r in bad), default=0.0)}
                    print(f"{key}: {len(bad)} of {len(runs)} processes wrong", res[key], flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
