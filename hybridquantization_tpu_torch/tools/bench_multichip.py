"""Scaling of the column-sharded engine per pixel-shard count.

Counterpart of the JAX package's `tools/bench_multichip.py`: for each shard
count n, n ranks (parallel.multihost.launch) run ShardedBatchQuantizer's
column-sharded fitness (parallel.fast: B1 and B2s per shard, guard
exchanges, member-pipelined collectives) on a (1, 1, n) mesh, and the
median of `reps` timed chunks of `iters` SWASA iterations gives ms per
iteration. The inputs are the JAX script's: one numpy seed-0 image, K=256,
population 4, conv_precision "bf16".

    python -m hybridquantization_tpu_torch.tools.bench_multichip [--shards 1,2,4] [--size 2160x3840]
        [--colors 256] [--population 4] [--iters 10] [--reps 3] [--cpu]

It runs on "cuda" over NCCL, one card per rank, unless the caller asks for
the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _time_chunks(rank, H, W, colors, population, iters, reps, device) -> float:
    """One rank of a shard count: seconds per iteration (median of reps)."""
    from .. import QuantizationConfig, SWASAConfig
    from ..parallel import ShardedBatchQuantizer, make_mesh
    from ..swasa import loop as swasa_loop

    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=colors, population=population, imax=10**6), conv_precision="bf16"
    )
    q = ShardedBatchQuantizer(cfg, make_mesh(1, None, 1, device), strategy="columns")
    images = torch.as_tensor(np.random.default_rng(0).random((1, H, W, 3), dtype=np.float32), device=q.device)
    fitness = q._columns[0](images)
    state = swasa_loop.init_state((torch.Generator(device=q.device).manual_seed(0),), fitness, cfg.swasa)
    state, _ = swasa_loop.run_chunk(state, fitness, cfg.swasa, iters)  # warm; copies to the host
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = swasa_loop.run_chunk(state, fitness, cfg.swasa, iters)
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[len(times) // 2]


def measure_scaling(shard_counts, H, W, colors=256, population=4, iters=10, reps=3, log=None,
                    device="cuda") -> list[dict]:
    """One row per feasible shard count: pixel_shards, iter_ms, iters_per_s,
    eval_mpix_per_s, and beyond the first feasible count speedup_vs_<first>
    and scaling_efficiency. Counts whose column plan is infeasible are
    skipped."""
    from ..parallel import plan_fast
    from ..parallel.multihost import launch
    from ..scielab.filters import build_filters

    half = build_filters().half_width
    rows = []
    for n in shard_counts:
        if not plan_fast(H, W, half, n)[1]:
            if log:
                log(f"shards={n}: column plan infeasible, skipped")
            continue
        dt = launch(_time_chunks, n, (H, W, colors, population, iters, reps, str(device)), device=device)[0]
        row = {"pixel_shards": n, "iter_ms": dt * 1e3, "iters_per_s": 1.0 / dt,
               "eval_mpix_per_s": population * H * W / dt / 1e6}
        if rows:
            base = rows[0]
            row[f"speedup_vs_{base['pixel_shards']}"] = base["iter_ms"] / row["iter_ms"]
            row["scaling_efficiency"] = base["iter_ms"] / row["iter_ms"] * base["pixel_shards"] / n
        rows.append(row)
        if log:
            log(json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_multichip")
    ap.add_argument("--shards", default="", help="comma list of pixel-shard counts (default 1, 2, 4, 8 up to the cards)")
    ap.add_argument("--size", default="2160x3840", help="HxW")
    ap.add_argument("--colors", "-k", type=int, default=256)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10, help="iterations per timed chunk")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    H, W = (int(v) for v in args.size.split("x"))
    cards = torch.cuda.device_count()
    counts = ([int(s) for s in args.shards.split(",")] if args.shards
              else [n for n in (1, 2, 4, 8) if n <= max(cards, 1)])
    from . import device_line

    print(device_line(torch.device(device)), file=sys.stderr)
    print(f"cards {cards}, image {H}x{W}, K={args.colors}, pop={args.population}", file=sys.stderr)
    rows = measure_scaling(counts, H, W, args.colors, args.population, args.iters, args.reps,
                           log=print, device=device)
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
