"""Read the numbers the limits of `limits/<cell>.json` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 100-111 --control-seeds 100-102

For each seed it makes the cell's image set, runs the timed path's jobs
once over it (a batch cell: one job; a single-image cell: each image of
its set once), and prints, as
one JSON line, the worst reading of each compared number against the
reference (the program's, the lower readings). For each control seed it
also prints the numbers of the control, the reference in TF32 put in the
program's place after the search (the upper readings). The runs of the
benchmark itself never run the control. `--stuck` plants a fault in the
program, an anneal step that returns its state unchanged, to read how far
it moves the cell's numbers and its Delta-E.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seed_list(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, seed: int, device, control: bool, warm: bool) -> dict:
    import torch

    from benchmark import harness
    from benchmark.tracing import Tracer

    run = harness.Run(cell, seed, device, Tracer(False))
    if warm:
        run.warm_up()
    t0 = time.perf_counter()
    records = []
    for i in range(1 if run.batch else len(run.images)):
        recs, _ = run.job(i)
        records.extend(recs)
    seconds = time.perf_counter() - t0
    del run.engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"cell": cell.name, "seed": seed, "images": len(records), "jobs_s": seconds}
    out["program"], ref_de = harness.judge(run, records)
    out["delta_e"] = sum(ref_de.values()) / len(ref_de)
    if control:
        out["control"], _ = harness.judge(run, records, control=True)
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description="Readings of the compared numbers, program and control.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 100-111")
    p.add_argument("--control-seeds", default="", help="seeds also read with the control")
    p.add_argument("--out", help="also append each line to this file")
    p.add_argument("--stuck", action="store_true", help="every anneal step returns its state unchanged")
    args = p.parse_args(argv)
    import torch

    from benchmark import cells

    if device is None:
        if not torch.cuda.is_available():
            print("readings: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda:0"
    cell = cells.load(args.workload)
    if args.stuck:
        from hybridquantization_tpu_torch.swasa import loop

        def make_step(fitness, cfg):
            def step(state, ite, draws=None):
                t = state.best_error[..., None].expand(*state.best_error.shape, 4)
                return state, t
            return step

        loop.make_step = make_step
    controls = set(seed_list(args.control_seeds)) if args.control_seeds else set()
    for k, seed in enumerate(seed_list(args.seeds)):
        line = json.dumps(readings(cell, seed, device, seed in controls, warm=k == 0))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
