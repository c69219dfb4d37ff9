#!/usr/bin/env python3
"""The quality-parity layers of docs/PARITY.md for the port, on one GPU.

    python3 chip_parity.py [--out docs/evidence_h100]

Run from the root of a checkout. The port's engine is held to the f64
oracle (`tests/oracle.py`) at the BASELINE configurations, in this order:

  (a) layer 2, deterministic fitness parity: the port's `fitness_parity`
      (B1 and B2 on the card) against the oracle's fitness on identical
      random palettes, at config-1 (512x512, K=16) and config-2
      (1024x1024, K=64), each with smooth and natural content, 12 palette
      batches of population 4, tolerance 1e-3; one log each;
  (b) layer 3, the anneal's final quality: the port's `engine_run` at imax
      1500, population 4, f32x3, sRGB assignment, seeds 0-127 at config-1
      smooth, 0-95 at config-1 natural and 0-47 at config-2 smooth (the
      sizes of the JAX engine banks it is set against, config-2 cut to
      half); one JSONL bank each;
  (c) reports by the frozen `tools/parity_report.py`: each bank against
      its oracle bank in `docs/evidence/` and against the JAX TPU engine
      bank of the same configuration (both sides judged by the same oracle).

Every stage resumes: a layer-2 log that holds its verdict is kept, and a
bank keeps its seeds, so a call cut by its time limit loses no seed.
Then it prints each verdict. It exits 1 if a layer-2 run fails, or if the
port's mean Delta-E is off the JAX engine's by more than 1% beyond one
sigma of seed noise (a port fault), and non-zero on any error or without a
CUDA device. The layer-3 verdicts against the oracle are recorded as the
report prints them (PASS, INCONCLUSIVE or FAIL).

Imports torch, numpy, scipy (the oracle), the standard library and the
port; never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EVIDENCE = os.path.join(REPO, "docs", "evidence")

#: layer 2: (name, content, size, colors)
LAYER2 = (("config1", "smooth", 512, 16), ("config1nat", "natural", 512, 16),
          ("config2", "smooth", 1024, 64), ("config2nat", "natural", 1024, 64))
LAYER2_ARGS = ["--palettes", "12", "--population", "4", "--tolerance", "1e-3"]
#: layer 3: (name, content, size, colors, seeds, oracle bank, JAX engine bank)
LAYER3 = (
    ("config1", "smooth", 512, 16, "0-127", "oracle_config1_r04.jsonl", "engine_config1_r04.jsonl"),
    ("config1nat", "natural", 512, 16, "0-95", "oracle_config1nat_r04.jsonl",
     "engine_config1nat_r04.jsonl"),
    ("config2", "smooth", 1024, 64, "0-47", "oracle_config2_r05.jsonl", "engine_config2_r04.jsonl"),
)
LAYER3_ARGS = ["--imax", "1500", "--population", "4", "--precision", "f32x3",
               "--assignment-space", "srgb"]
#: the port against the JAX engine: a fault when |gap| - 1 sigma exceeds this
JAX_GAP = 0.01
VERDICT = "DETERMINISTIC PARITY:"


class _Tee:
    """Writes to a file and to the real stdout."""

    def __init__(self, f):
        self.f, self.out = f, sys.stdout

    def write(self, s):
        self.f.write(s)
        return self.out.write(s)

    def flush(self):
        self.f.flush()
        self.out.flush()


def layer2(out: str, device) -> dict:
    """Each layer-2 run's verdict line; runs those whose log has none."""
    from hybridquantization_tpu_torch.tools import fitness_parity

    verdicts = {}
    for name, content, size, colors in LAYER2:
        log = os.path.join(out, f"fitness_parity_{name}.log")
        if not _verdict(log):
            t0 = time.perf_counter()
            argv = ["--content", content, "--size", str(size), "--colors", str(colors), *LAYER2_ARGS]
            print(f"[layer 2] {name}: fitness_parity {' '.join(argv)}", flush=True)
            with open(log, "w") as f, contextlib.redirect_stdout(_Tee(f)):
                fitness_parity.main(argv, device=device)
            print(f"[layer 2] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        verdicts[name] = _verdict(log)
    return verdicts


def _verdict(log: str) -> str | None:
    if not os.path.exists(log):
        return None
    with open(log) as f:
        return next((ln.strip() for ln in f if ln.startswith(VERDICT)), None)


def layer3(out: str, device) -> None:
    """Each bank to its full seed count (engine_run skips the seeds it has)."""
    from hybridquantization_tpu_torch.tools import engine_run

    for name, content, size, colors, seeds, _, _ in LAYER3:
        t0 = time.perf_counter()
        argv = ["--content", content, "--size", str(size), "--colors", str(colors),
                "--seeds", seeds, *LAYER3_ARGS, "--out", os.path.join(out, f"engine_{name}.jsonl")]
        print(f"[layer 3] {name}: engine_run {' '.join(argv)}", flush=True)
        if engine_run.main(argv, device=device) != 0:
            raise RuntimeError(f"engine_run failed for {name}")
        print(f"[layer 3] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def report(engine: str, against: str, dest: str) -> tuple[str, float, float]:
    """The frozen report of `engine` against `against`, written to `dest`:
    (its PARITY line, Delta-E gap, its 1 sigma), the gap and sigma as fractions."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "parity_report.py"),
         "--engine", engine, "--oracle", against],
        capture_output=True, text=True, timeout=120,
    )
    with open(dest, "w") as f:
        f.write(r.stdout)
    print(r.stdout, end="", flush=True)
    verdict = next((ln for ln in r.stdout.splitlines() if ln.startswith("PARITY:")), None)
    gap = re.search(r"gap ([-+]\d+\.\d+)%\s+± (\d+\.\d+)%", r.stdout)
    if r.returncode not in (0, 1) or verdict is None or gap is None:
        raise RuntimeError(f"parity_report failed on {engine} (rc {r.returncode}): {r.stderr}")
    return verdict, float(gap.group(1)) / 100, float(gap.group(2)) / 100


def reports(out: str) -> list[str]:
    """Every bank against its oracle bank and its JAX bank; the faults."""
    faults = []
    for name, *_, oracle_bank, jax_bank in LAYER3:
        bank = os.path.join(out, f"engine_{name}.jsonl")
        for side, src in (("oracle", oracle_bank), ("jax", jax_bank)):
            print(f"[report] {name}: port bank against {src}", flush=True)
            verdict, gap, sigma = report(bank, os.path.join(EVIDENCE, src),
                                         os.path.join(out, f"report_{name}_vs_{side}.txt"))
            if side == "jax" and abs(gap) - sigma > JAX_GAP:
                faults.append(f"{name}: Delta-E gap to the JAX engine {gap:+.2%} ± {sigma:.2%}")
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "evidence_h100"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_parity: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.tools import device_line

    dev = setup_device("cuda")
    print(device_line(dev), flush=True)
    os.makedirs(args.out, exist_ok=True)
    l2 = layer2(args.out, dev)
    layer3(args.out, dev)
    faults = reports(args.out)
    faults += [f"{n}: {v}" for n, v in l2.items() if "PASS" not in v]
    for name, v in l2.items():
        print(f"layer 2 {name}: {v}")
    for name, *_ in LAYER3:
        for side in ("oracle", "jax"):
            path = os.path.join(args.out, f"report_{name}_vs_{side}.txt")
            with open(path) as f:
                print(f"layer 3 {name} vs {side}: "
                      + next(ln for ln in f if ln.startswith("PARITY:")).strip())
    for fault in faults:
        print(f"FAULT: {fault}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
