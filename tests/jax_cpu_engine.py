"""Layer 3 (`tools/engine_run.py`'s protocol) with the JAX engine run on the CPU.

    python tests/jax_cpu_engine.py --content natural --size 512 --colors 16 \\
        --seeds 0-23 --branch xla --out BANK.jsonl [--series SERIES.jsonl]

Each seed runs `hybridquantization_tpu.HybridQuantizer.find_palette` with
`key=jax.random.PRNGKey(seed)` and `chunk_size=imax`, exactly as the frozen
`tools/engine_run.py` does on the TPU, and is judged by the same f64 oracle
judge (`parity_check.quality`), so a bank of it pairs seed by seed with the
TPU engine's banks and with the port's banks on JAX's own draw stream
(`chip_draws.py --draws jax`). Branches:

  --branch xla     the default `use_pallas="auto"`: off the TPU, JAX's
                   fitness in XLA at f32, except that its assignment at the
                   default precision "f32x3" scores with three bf16 hi/lo
                   dots (`hybridquantization_tpu/ops/assign.py:_scores`),
                   neither the Pallas kernel's split nor fp32 scores
                   (`chip_draws.py --fitness xla` is the port's
                   counterpart);
  --branch f32x3   `use_pallas="on"`, `precision="f32x3"`: the TPU kernels'
                   function (bf16 hi/lo splits inside the assignment and the
                   fused S-CIELAB kernel) in interpret mode, XLA's f32
                   arithmetic in XLA's orders of accumulation.

Records carry `tools/engine_run.py`'s keys plus "engine": "jax-cpu" and
"branch". `--series PATH` appends, per seed, every iteration's best error
(`info["telemetry"]["best_error"]`), the counterpart of `chip_draws.py
--series`. Seeds already in the bank are skipped, so a cut run keeps its
seeds. On 8 CPU cores a config-1 natural seed (512^2, K=16, pop 4, imax
1500) takes about 2.5 min on the xla branch and 19 min on the f32x3 branch.

`--precision highest` on the xla branch is JAX's f32 function (a
`Precision.HIGHEST` dot in the assignment, the conv at f32): the function
the port's fp32 engine computes, so its bank pairs with the port's fp32
bank on JAX's streams (`chip_parity.py`'s off-TPU gate). `--jobs N` runs N
processes, each pinned to its share of the cores, with the seeds dealt
round-robin, so the lowest seeds finish first; on 8 cores an imax-150
anneal took 44 s a seed in one process and 22 s a seed in four of two
cores, with bit-equal results. Every record and series line is appended
in one write, so the processes share the two files.

Like the tests, this script imports jax and the port; it is not collected
by pytest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hybridquantization_tpu import HybridQuantizer as JQuantizer  # noqa: E402
from hybridquantization_tpu import QuantizationConfig as JConfig  # noqa: E402
from hybridquantization_tpu import SWASAConfig as JSWASA  # noqa: E402

#: --branch -> QuantizationConfig's (use_pallas, precision)
BRANCHES = {"xla": ("auto", None), "f32x3": ("on", "f32x3")}


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="natural", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", "-k", type=int, default=16)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--seeds", default="0-23", help="e.g. 0-23 or 3,5,7")
    ap.add_argument("--branch", default="xla", choices=list(BRANCHES))
    ap.add_argument("--precision", default="f32x3", choices=["highest", "f32x3", "bf16"],
                    help="the xla branch's precision field (f32x3 branch: always f32x3)")
    ap.add_argument("--assignment-space", default="srgb", choices=["srgb", "lab"])
    ap.add_argument("--conv-precision", default="", choices=["", "highest", "f32x3", "bf16"])
    ap.add_argument("--series", default="", help="append each seed's per-iteration best error here")
    ap.add_argument("--jobs", type=int, default=1, help="processes, each pinned to its share of the cores")
    ap.add_argument("--out", required=True)
    return ap.parse_args(argv)


def append(path: str, rec: dict) -> None:
    """`rec` as one JSON line at the end of `path`, in a single write (so
    processes sharing the file never interleave), synced to disk."""
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        line = (json.dumps(rec) + "\n").encode()
        if os.write(fd, line) != len(line):
            raise OSError(f"short write to {path}")
        os.fsync(fd)
    finally:
        os.close(fd)


def main(argv=None) -> int:
    from hybridquantization_tpu_torch.tools.engine_run import done_seeds, parse_seeds, run_jobs
    from hybridquantization_tpu_torch.tools.parity_check import content_image, judge_target, quality

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    done = done_seeds(args.out)
    todo = [s for s in parse_seeds(args.seeds) if s not in done]
    print(f"seeds todo {todo} (already done: {sorted(done)})", flush=True)
    if not todo:
        return 0
    if args.jobs > 1:
        return run_jobs(os.path.abspath(__file__), argv, todo, args.jobs, pin=True)
    use_pallas, precision = BRANCHES[args.branch]
    precision = precision or args.precision
    img = content_image(args.content, args.size)
    target64 = judge_target(img)
    engine = JQuantizer(JConfig(
        swasa=JSWASA(num_colors=args.colors, population=args.population, imax=args.imax),
        precision=precision, conv_precision=args.conv_precision,
        assignment_space=args.assignment_space, use_pallas=use_pallas,
    ))
    for i, s in enumerate(todo):
        if s in done_seeds(args.out):  # banked meanwhile by another process on the same file
            continue
        t0 = time.time()
        pal, info = engine.find_palette(img, key=jax.random.PRNGKey(s), chunk_size=args.imax)
        palette = np.asarray(pal, np.float64)
        t_anneal = time.time() - t0
        de, mse = quality(img, palette, target64, args.assignment_space)
        rec = {
            "seed": s, "deltaE": de, "mse": mse, "precision": precision,
            "size": args.size, "colors": args.colors, "imax": args.imax,
            "population": args.population, "content": args.content,
            "assignment_space": args.assignment_space, "anneal_seconds": round(t_anneal, 1),
            "engine": "jax-cpu", "branch": args.branch,
        }
        if i == 0:
            rec["compile_inclusive"] = True
        if args.series:
            best = np.asarray(info["telemetry"]["best_error"], np.float64)
            append(args.series, {"seed": s, "engine": "jax-cpu", "branch": args.branch,
                                 "precision": precision, "deltaE": de, "best_error": best.tolist()})
        append(args.out, rec)
        print(f"[jax-cpu {args.branch}] {rec}", flush=True)
    print("all requested seeds done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
