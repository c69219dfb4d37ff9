"""Run the port's SWASA seeds to a resumable JSONL file (layer 3, engine side).

The counterpart of `tools/engine_run.py`, with the same flags and records:
each seed runs the full `HybridQuantizer.find_palette` anneal (B1 and B2
every iteration on the card) from `torch.Generator(device).manual_seed(seed)`
and is judged on the host by the f64 oracle judge (`parity_check.quality`:
mean S-CIELAB Delta-E76 and sRGB MSE of the final first-minimum
quantization), the same judge as the oracle seeds', so the frozen
`tools/parity_report.py` reads this file against an oracle bank or a JAX
engine bank. Records carry the JAX tool's keys plus "engine": "torch" and
"device" (nvidia-smi's name and power limit, or "cpu"). The first seed of
a call is flagged `compile_inclusive`: it pays the kernel build and the
card's warm-up. Seeds already in the file are skipped.

Usage:
  python -m hybridquantization_tpu_torch.tools.engine_run --size 1024 --colors 64 \\
      --imax 1500 --seeds 0-23 --out engine_c2.jsonl [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from .parity_check import content_image, judge_target, quality


def parse_seeds(spec: str) -> list[int]:
    """"0-23" or "3,5,7" (or both, comma-separated) -> the seeds."""
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def done_seeds(path: str) -> set:
    """The seeds already recorded in the JSONL file at `path`."""
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["seed"])
                except (ValueError, KeyError):
                    pass
    return done


def run_jobs(script: str, argv: list, seeds: list, jobs: int, pin: bool = False) -> int:
    """`seeds` over `jobs` processes of `script` (each given `argv`, its
    share of the seeds dealt round-robin so the lowest finish first, and
    `--jobs 1`); with `pin`, each process pinned to its share of this
    process's cores. The worst exit code."""
    cores = sorted(os.sched_getaffinity(0))
    jobs = min(jobs, len(seeds), len(cores) if pin else jobs)
    procs = []
    try:
        for j in range(jobs):
            share = set(cores[j * len(cores) // jobs:(j + 1) * len(cores) // jobs])
            procs.append(subprocess.Popen(
                [sys.executable, script, *argv, "--seeds", ",".join(map(str, seeds[j::jobs])), "--jobs", "1"],
                preexec_fn=(lambda share=share: os.sched_setaffinity(0, share)) if pin else None))
        return max(p.wait() for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait()


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="smooth", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--colors", "-k", type=int, default=64)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--seeds", default="0-23", help="e.g. 0-23 or 3,5,7")
    ap.add_argument("--precision", default="f32x3", choices=["highest", "f32x3", "bf16"])
    ap.add_argument("--assignment-space", default="srgb", choices=["srgb", "lab"],
                    help="srgb = reference parity mode; lab = the BASELINE north-star Delta-E "
                    "assignment (recorded in the JSONL as assignment_space)")
    ap.add_argument("--conv-precision", default="", choices=["", "highest", "f32x3", "bf16"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    return ap.parse_args(argv)


def main(argv=None, *, device="cuda") -> int:
    args = parse_args(argv)
    import torch

    from .. import HybridQuantizer, QuantizationConfig, SWASAConfig
    from ..pipeline import setup_device
    from . import smi_line

    dev = setup_device("cpu" if args.cpu else device)
    done = done_seeds(args.out)
    todo = [s for s in parse_seeds(args.seeds) if s not in done]
    print(f"seeds todo {todo} (already done: {sorted(done)})", flush=True)
    if not todo:
        return 0

    img = content_image(args.content, args.size)
    target64 = judge_target(img)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=args.colors, population=args.population, imax=args.imax),
        precision=args.precision, conv_precision=args.conv_precision,
        assignment_space=args.assignment_space,
    )
    engine = HybridQuantizer(cfg, device=dev)
    device_name = smi_line() if dev.type == "cuda" else "cpu"

    for i, s in enumerate(todo):
        t0 = time.time()
        pal, _info = engine.find_palette(
            img, generator=torch.Generator(device=dev).manual_seed(s), chunk_size=args.imax
        )
        palette = pal.cpu().numpy().astype(np.float64)  # waits for the card
        t_anneal = time.time() - t0
        de, mse = quality(img, palette, target64, args.assignment_space)
        rec = {
            "seed": s, "deltaE": de, "mse": mse, "precision": args.precision,
            "size": args.size, "colors": args.colors, "imax": args.imax,
            "population": args.population, "content": args.content,
            "assignment_space": args.assignment_space, "anneal_seconds": round(t_anneal, 3),
            "engine": "torch", "device": device_name,
        }
        if i == 0:
            rec["compile_inclusive"] = True
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        print(f"[engine done] {rec}", flush=True)
    print("all requested seeds done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
