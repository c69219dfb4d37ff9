"""Run NumPy-oracle SWASA seeds to a resumable JSONL file.

The counterpart of `tools/oracle_run.py`, with the same flags and records,
and without jax: the content comes from the port's
`parity_check.content_image` (bit-equal to the JAX tool's), the search and
the judge from `tests/oracle.py` through `parity_check.load_oracle()`.

  - The requested seeds are dealt to `--jobs` worker processes started by
    "spawn" (a module-level worker), each with one BLAS/OpenMP thread, so
    `--jobs` equal to the host's cores does not oversubscribe them.
  - Each finished seed appends one JSON line to --out (flushed and
    fsynced, under a lock): seed, deltaE, mse (the f64 judge's, as
    `parity_check.quality`), search_fitness, dtype, size, colors, imax,
    population, content, seconds.
  - Seeds already present in --out are skipped (resume across calls).
  - Each worker heartbeats its progress to <out>.hb.<pid> as a seed starts
    and every 100 iterations.
  - SIGTERM (e.g. from `timeout`) ends the workers with the tool; seeds in
    progress are lost, finished ones kept.

A bank that continues an older one starts as a copy of its records.

Usage:
  python -m hybridquantization_tpu_torch.tools.oracle_run --content natural \\
      --size 512 --colors 16 --imax 1500 --seeds 40-95 --jobs 8 --dtype f32 \\
      --out oracle_config1nat.jsonl
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import signal
import time

import numpy as np

from .engine_run import done_seeds, parse_seeds
from .parity_check import content_image, judge_target, load_oracle, quality

#: the BLAS/OpenMP pools a worker pins to one thread, set before numpy loads
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
               "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS")


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="smooth", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--colors", "-k", type=int, default=64)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2,3", help="e.g. 0,1,2,3 or 40-95")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--out", required=True)
    return ap.parse_args(argv)


def run_seed(img: np.ndarray, target64: np.ndarray, seed: int, args, progress=None) -> dict:
    """One oracle seed searched and judged: its record."""
    oracle = load_oracle()
    odtype = np.float32 if args.dtype == "f32" else np.float64
    t0 = time.time()
    pal, err = oracle.swasa_search(
        img.astype(odtype), args.colors, seed=seed, population=args.population, imax=args.imax,
        dtype=odtype, progress=progress,
    )
    de, mse = quality(img, np.asarray(pal, np.float64), target64)
    return {
        "seed": seed, "deltaE": de, "mse": mse, "search_fitness": float(err),
        "dtype": args.dtype, "size": args.size, "colors": args.colors, "imax": args.imax,
        "population": args.population, "content": args.content,
        "seconds": round(time.time() - t0, 1),
    }


def _worker(seeds, args, lock) -> None:
    """Search and judge `seeds` in turn, appending each record to args.out.
    Module-level, so a spawned process can unpickle it."""
    img = content_image(args.content, args.size)
    target64 = judge_target(img)
    hb_path = f"{args.out}.hb.{os.getpid()}"
    for s in seeds:
        t0 = time.time()

        def progress(ite, s=s, t0=t0):
            with open(hb_path, "w") as hb:
                hb.write(f"seed {s} iter {ite}/{args.imax} {time.time() - t0:.0f}s\n")

        progress(0)  # the oracle beats every 100 iterations
        rec = run_seed(img, target64, s, args, progress)
        with lock:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        print(f"[oracle done] {rec}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    args.out = os.path.abspath(args.out)
    done = done_seeds(args.out)
    todo = [s for s in parse_seeds(args.seeds) if s not in done]
    print(f"seeds todo {todo} (already done: {sorted(done)})", flush=True)
    if not todo:
        return 0
    ctx = multiprocessing.get_context("spawn")
    lock = ctx.Lock()
    chunks = [todo[j :: args.jobs] for j in range(args.jobs)]
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})  # inherited by the spawned workers
    try:
        procs = [ctx.Process(target=_worker, args=(c, args, lock)) for c in chunks if c]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def stop(signum, _frame):  # a timeout or a kill ends the workers too
        for p in procs:
            p.terminate()
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    for p in procs:
        p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        print(f"ERROR: {len(failed)} oracle worker(s) failed (exit codes {failed})", flush=True)
        return 1
    print("all requested seeds done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
