#!/usr/bin/env python3
"""The quality-parity layers of docs/PARITY.md for the port, on one GPU.

    python3 chip_parity.py [--out docs/evidence_h100] [--configs config2nat,config1_lab]

Run from the root of a checkout. The port's engine is held to the f64
oracle (`tests/oracle.py`) and to the JAX TPU engine at the BASELINE
configurations, in this order:

  (a) layer 2, deterministic fitness parity: the port's `fitness_parity`
      (B1 and B2 on the card) against the oracle's fitness on identical
      random palettes, at config-1 (512x512, K=16) and config-2
      (1024x1024, K=64), each with smooth and natural content, 12 palette
      batches of population 4, tolerance 1e-3; one log each;
  (b) layer 3, the anneal's final quality, for each `LAYER3` row (its
      content, size, K, precision, conv precision and assignment space;
      imax 1500, population 4): the port's `engine_run` from the card's
      Philox generator (`engine_<row>.jsonl`: seeds 0-127 at config-1
      smooth, 0-95 at config-1 natural, 0-47 elsewhere), and the port on
      the JAX engine's own draw stream (`chip_draws.py --draws jax`, the
      row's `paired` bank, on the JAX bank's seeds, 0-23 where no earlier
      bank holds more); a row that `shares` another's banks (the
      "highest" row, config-1's fp32 engine) anneals none of its own;
  (c) reports: by the frozen `tools/parity_report.py`, each card bank
      against its oracle bank in `docs/evidence/` (rows that have one) and
      against the JAX TPU engine bank of the same configuration (both sides
      judged by the same oracle); and each JAX-stream bank paired with the
      JAX bank seed by seed (`tools.paired`, `paired_<row>_vs_jax.txt`);
      and where the row names a committed off-TPU JAX bank (`jax_cpu`,
      config-1 natural: `tests/jax_cpu_engine.py --branch xla --precision
      highest`, JAX's f32 engine on the CPU), the JAX-stream bank paired
      with that bank (`paired_<row>_vs_jaxcpu.txt`).

`--configs` chooses the layer-3 rows (and the layer-2 runs of the same
names); by default all of them. Every stage resumes: a layer-2 log that
holds its verdict is kept, and a bank keeps its seeds, so a call cut by
its time limit loses no seed. Then it prints each verdict and a `FAULT:`
line for each fault. It exits 1 if a layer-2 run fails; if the card
bank's mean Delta-E is off the JAX engine's by more than 1% beyond one
sigma of seed noise (the unpaired gate, JAX_GAP); or if the paired gate
fails: the JAX-stream bank's mean difference from the JAX bank lies more
than 2 SE from zero and the sign test over its diverged seeds gives
p < 0.05 (`tools.paired`); or if the off-TPU gate fails: the JAX-stream
bank's mean difference from the off-TPU bank lies more than 2 SE from zero
OR the sign test gives p < 0.05 (`Paired.same_function_fault`, a
`FAULT: <row> jax-cpu:` line). That gate anneals nothing, and it may be
stricter than the TPU-paired one: the port's fp32 engine and JAX's engine
at precision "highest" compute one function and draw one stream, so they
are meant to agree seed by seed, and a minority of seeds hit hard one way
is a fault there, where against the TPU's own arithmetic it is not. It
exits non-zero on any error or without a CUDA device. The layer-3
verdicts against the oracle are recorded as the report prints them
(PASS, INCONCLUSIVE or FAIL).

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
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))
EVIDENCE = os.path.join(REPO, "docs", "evidence")
EVIDENCE_H100 = os.path.join(REPO, "docs", "evidence_h100")

#: layer 2: (name, content, size, colors)
LAYER2 = (("config1", "smooth", 512, 16), ("config1nat", "natural", 512, 16),
          ("config2", "smooth", 1024, 64), ("config2nat", "natural", 1024, 64))
LAYER2_ARGS = ["--palettes", "12", "--population", "4", "--tolerance", "1e-3"]


class Row(NamedTuple):
    """A layer-3 configuration: its banks and the engine's mode."""

    name: str
    content: str
    size: int
    colors: int
    seeds: str                # the card-Philox bank's (engine_run)
    oracle: str | None        # its oracle bank in docs/evidence/; None: against JAX only
    jax: str                  # the JAX TPU engine's bank in docs/evidence/
    paired: str               # the bank on JAX's draw stream, relative to --out
    paired_seeds: str
    precision: str = "f32x3"  # the port's "highest" and "f32x3" are the same fp32 engine
    conv_precision: str = ""
    space: str = "srgb"
    shares: str = ""          # the row whose two banks this row reads ("": its own)
    jax_cpu: str = ""         # a committed off-TPU JAX bank of the port's function, in docs/evidence_h100/


CONFIG1 = Row("config1", "smooth", 512, 16, "0-127", "oracle_config1_r04.jsonl", "engine_config1_r04.jsonl",
              "draws_config1_jax.jsonl", "0-23")
LAYER3 = (
    CONFIG1,
    Row("config1nat", "natural", 512, 16, "0-95", "oracle_config1nat_r04.jsonl", "engine_config1nat_r04.jsonl",
        os.path.join("c2", "draws_config1nat_fp32_jax.jsonl"), "0-95",
        jax_cpu=os.path.join("c2", "jaxcpu_config1nat_highest.jsonl")),
    Row("config2", "smooth", 1024, 64, "0-47", "oracle_config2_r05.jsonl", "engine_config2_r04.jsonl",
        os.path.join("c2", "draws_config2_fp32_jax.jsonl"), "0-95"),
    Row("config2nat", "natural", 1024, 64, "0-47", None, "engine_config2nat_r04.jsonl",
        "draws_config2nat_jax.jsonl", "0-23"),
    Row("config1_lab", "smooth", 512, 16, "0-47", None, "engine_config1_lab_r05.jsonl",
        "draws_config1_lab_jax.jsonl", "0-23", space="lab"),
    Row("config2_lab", "smooth", 1024, 64, "0-47", None, "engine_config2_lab_r05.jsonl",
        "draws_config2_lab_jax.jsonl", "0-23", space="lab"),
    Row("config1_bf16", "smooth", 512, 16, "0-47", None, "engine_config1_bf16_r04.jsonl",
        "draws_config1_bf16_jax.jsonl", "0-23", precision="bf16"),
    Row("config1_convbf16", "smooth", 512, 16, "0-47", None, "engine_config1_convbf16_r04.jsonl",
        "draws_config1_convbf16_jax.jsonl", "0-23", conv_precision="bf16"),
    # the port's "highest" is config-1's fp32 engine: its banks were bit-equal to config-1's
    # (48/48 card seeds, 24/24 on JAX's stream), so the row reads config-1's against JAX's highest bank
    CONFIG1._replace(name="config1_highest", oracle=None, jax="engine_config1_highest_r04.jsonl",
                     shares="config1"),
)
#: both tools' anneal (chip_draws runs population 4, as engine_run is told to)
LAYER3_ARGS = ["--imax", "1500"]
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


def layer2(out: str, device, names=None) -> dict:
    """Each layer-2 run's verdict line (those named in `names`, or all);
    runs those whose log has none."""
    from hybridquantization_tpu_torch.tools import fitness_parity

    verdicts = {}
    for name, content, size, colors in LAYER2:
        if names is not None and name not in names:
            continue
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


def owners(rows) -> tuple:
    """The rows whose banks `rows` read, each once, in order: a row that
    shares another's banks stands for that row."""
    by_name = {row.name: row for row in LAYER3}
    out = {}
    for row in rows:
        owner = by_name[row.shares] if row.shares else row
        out.setdefault(owner.name, owner)
    return tuple(out.values())


def card_bank(out: str, row: Row) -> str:
    """The row's card-Philox bank (its sharer's when it shares)."""
    return os.path.join(out, f"engine_{row.shares or row.name}.jsonl")


def layer3(out: str, device, rows=LAYER3) -> None:
    """Each row's two banks to their full seed counts (engine_run and
    chip_draws skip the seeds they have): the card-Philox bank, then the
    bank on JAX's draw stream; a row that shares another's banks runs that
    row's, once."""
    import chip_draws
    from hybridquantization_tpu_torch.tools import engine_run

    for row in owners(rows):
        shape = ["--content", row.content, "--size", str(row.size), "--colors", str(row.colors), *LAYER3_ARGS,
                 "--precision", row.precision, "--conv-precision", row.conv_precision]
        runs = (("engine_run", engine_run.main,
                 [*shape, "--population", "4", "--assignment-space", row.space, "--seeds", row.seeds,
                  "--out", card_bank(out, row)]),
                ("chip_draws --draws jax", chip_draws.main,
                 [*shape, "--space", row.space, "--draws", "jax", "--fitness", "fp32",
                  "--seeds", row.paired_seeds, "--out", os.path.join(out, row.paired)]))
        os.makedirs(os.path.dirname(os.path.join(out, row.paired)), exist_ok=True)
        for tool, run, argv in runs:
            t0 = time.perf_counter()
            print(f"[layer 3] {row.name}: {tool} {' '.join(argv)}", flush=True)
            if run(argv, device=device) != 0:
                raise RuntimeError(f"{tool} failed for {row.name}")
            print(f"[layer 3] {row.name}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def reports(out: str, rows=LAYER3) -> list[str]:
    """Each row's card bank against its oracle bank (where it has one) and
    its JAX bank, and its JAX-stream bank paired with the JAX bank; the faults."""
    from hybridquantization_tpu_torch.tools.paired import load, pair

    faults = []
    for row in rows:
        bank = card_bank(out, row)
        sides = ((("oracle", row.oracle),) if row.oracle else ()) + (("jax", row.jax),)
        for side, src in sides:
            print(f"[report] {row.name}: port bank against {src}", flush=True)
            verdict, gap, sigma = report(bank, os.path.join(EVIDENCE, src),
                                         os.path.join(out, f"report_{row.name}_vs_{side}.txt"))
            if side == "jax" and abs(gap) - sigma > JAX_GAP:
                faults.append(f"{row.name}: Delta-E gap to the JAX engine {gap:+.2%} ± {sigma:.2%}")
        p = pair(load(os.path.join(out, row.paired)), load(os.path.join(EVIDENCE, row.jax)))
        text = p.text() if p else "paired: fewer than 3 common seeds"
        with open(os.path.join(out, f"paired_{row.name}_vs_jax.txt"), "w") as f:
            f.write(f"{row.paired} against {row.jax}: {text}\n")
        print(f"[paired] {row.name}: {text}", flush=True)
        if p is None or p.fault:
            faults.append(f"{row.name} paired: {text}")
        if row.jax_cpu:
            faults += _jax_cpu_gate(out, row)
    return faults


def _jax_cpu_gate(out: str, row: Row) -> list[str]:
    """The row's JAX-stream bank paired with its off-TPU JAX bank, written
    to `paired_<row>_vs_jaxcpu.txt`; its fault, if the same-function gate
    fails."""
    from hybridquantization_tpu_torch.tools.paired import load, pair

    p = pair(load(os.path.join(out, row.paired)), load(os.path.join(EVIDENCE_H100, row.jax_cpu)))
    text = f"{p.text('port', 'JAX off the TPU')}; {p.rule_text()}" if p else "paired: fewer than 3 common seeds"
    with open(os.path.join(out, f"paired_{row.name}_vs_jaxcpu.txt"), "w") as f:
        f.write(f"{row.paired} against {row.jax_cpu}: {text}\n")
    print(f"[paired] {row.name} jax-cpu: {text}", flush=True)
    return [f"{row.name} jax-cpu: {text}"] if p is None or p.same_function_fault else []


def select(spec: str) -> tuple:
    """The LAYER3 rows named in "a,b,..." ("" = all), in the table's order."""
    names = [n for n in spec.split(",") if n]
    unknown = set(names) - {row.name for row in LAYER3}
    if unknown:
        raise SystemExit(f"chip_parity: unknown configurations {sorted(unknown)}; "
                         f"known: {','.join(row.name for row in LAYER3)}")
    return tuple(row for row in LAYER3 if not names or row.name in names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "evidence_h100"))
    ap.add_argument("--configs", default="", help="the layer-3 rows to run, e.g. config2nat,config1_lab "
                    "(default all)")
    args = ap.parse_args(argv)
    rows = select(args.configs)
    import torch

    if not torch.cuda.is_available():
        print("chip_parity: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.tools import device_line

    dev = setup_device("cuda")
    print(device_line(dev), flush=True)
    os.makedirs(args.out, exist_ok=True)
    l2 = layer2(args.out, dev, {row.name for row in rows})
    layer3(args.out, dev, rows)
    faults = reports(args.out, rows)
    faults += [f"{n}: {v}" for n, v in l2.items() if "PASS" not in v]
    for name, v in l2.items():
        print(f"layer 2 {name}: {v}")
    for row in rows:
        for side in ("oracle", "jax") if row.oracle else ("jax",):
            path = os.path.join(args.out, f"report_{row.name}_vs_{side}.txt")
            with open(path) as f:
                print(f"layer 3 {row.name} vs {side}: "
                      + next(ln for ln in f if ln.startswith("PARITY:")).strip())
        with open(os.path.join(args.out, f"paired_{row.name}_vs_jax.txt")) as f:
            print(f"layer 3 {row.name} paired vs jax: {f.read().strip()}")
        if row.jax_cpu:
            with open(os.path.join(args.out, f"paired_{row.name}_vs_jaxcpu.txt")) as f:
                print(f"layer 3 {row.name} paired vs jax-cpu: {f.read().strip()}")
    for fault in faults:
        print(f"FAULT: {fault}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
