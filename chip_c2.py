#!/usr/bin/env python3
"""Fault C2's diagnostics on one GPU, resumable, into docs/evidence_h100/c2/.

    python3 chip_c2.py [--stages layer2,banks,reports] [--deadline SECONDS]
                       [--oracle config1nat:5,config2:2] [--out DIR]

Run from the root of a checkout. ROADMAP fault C2: the port's annealed mean
ΔE sits above the JAX TPU engine's at config-1 natural (512x512, K=16) and
config-2 (1024x1024, K=64, smooth). Stages:

  layer2   (a) layer 2 with the TPU's f32x3 fitness emulated
           (`tools.tpu_f32x3`: split_assign, then B2) at config-1 and
           config-2, smooth and natural, `fitness_parity`'s protocol (12
           batches of 4 random palettes) against the f64 oracle: fitness
           gap and split_assign's flips; one log each;
  banks    through `chip_draws.py` (imax 1500, pop 4), in `BANKS` order:
           (b) `--assign split --draws device`, config-1 natural seeds
               0-191 and config-2 seeds 0-95, seeds 0-23 with `--counts`;
           (e) the fp32 engine's seeds 0-23 again with `--counts` (the
               same runs as the fp32 banks in this directory), last;
           (c) `--assign fp32 --draws jax` and (d) `--assign split --draws
               jax`, seeds 0-95 at each configuration, which pair seed by
               seed with the JAX TPU engine's banks, and (c') the fp32
               engine on JAX's streams of seeds 96-191, which no JAX bank
               holds;
  reports  every bank against the JAX TPU bank and the oracle bank by the
           frozen `tools/parity_report.py`; for (c) and (d) the paired
           per-seed difference from the JAX bank (mean ± SE), Pearson r
           and the seeds within 1e-3 relative; the counts by window of 150
           iterations, fp32 beside split.

`--oracle CONFIG:JOBS,...` runs the oracle's own seeds on this host's CPU
beside the card's work (`tools.oracle_run`, one process group, stopped at
the deadline, its log beside its bank): config-1 natural to seed 95 and
config-2 to seed 47, each bank starting as a copy of its `docs/evidence/`
bank. A bank seed starts only before `--deadline` seconds (from the start
of the call) have passed; every stage resumes from the files in `--out`
(default docs/evidence_h100/c2; a run whose outputs must be fetched from
another directory copies the evidence there first). Prints nproc first.
Exits non-zero on an error, on a layer-2 run that does not PASS (run
again on resume), or without a CUDA device.

Imports torch, numpy, scipy (the oracle), the standard library and the
port; never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

from chip_parity import VERDICT, _Tee, _verdict, report

REPO = os.path.dirname(os.path.abspath(__file__))
EVIDENCE = os.path.join(REPO, "docs", "evidence")
C2 = os.path.join(REPO, "docs", "evidence_h100", "c2")

#: name: (content, size, colors, JAX TPU bank, oracle bank to continue, its last seed,
#:        the port's fp32 device bank)
CONFIGS = {
    "config1nat": ("natural", 512, 16, "engine_config1nat_r04.jsonl", "oracle_config1nat_r04.jsonl", 95,
                   "engine_config1nat_0-191.jsonl"),
    "config2": ("smooth", 1024, 64, "engine_config2_r04.jsonl", "oracle_config2_r05.jsonl", 47,
                "engine_config2_0-95.jsonl"),
}
LAYER2 = (("config1", "smooth", 512, 16), ("config1nat", "natural", 512, 16),
          ("config2", "smooth", 1024, 64), ("config2nat", "natural", 1024, 64))
LAYER2_ARGS = ["--palettes", "12", "--population", "4", "--tolerance", "1e-3"]
#: (config, assign, draws, seeds, seeds with --counts, file tag), in the order they run;
#: the fp32 banks on JAX's streams of seeds 96-191, which no JAX bank holds,
#: tell a low sample of streams from a property of the stream
BANKS = (
    ("config1nat", "split", "device", "0-191", "0-23", ""),
    ("config1nat", "fp32", "jax", "0-95", "", ""),
    ("config2", "split", "device", "0-95", "0-23", ""),
    ("config2", "fp32", "jax", "0-95", "", ""),
    ("config1nat", "fp32", "jax", "96-191", "", "_96-191"),
    ("config2", "fp32", "jax", "96-191", "", "_96-191"),
    ("config1nat", "split", "jax", "0-95", "", ""),
    ("config2", "split", "jax", "0-95", "", ""),
    ("config1nat", "fp32", "device", "0-23", "0-23", ""),
    ("config2", "fp32", "device", "0-23", "0-23", ""),
)
#: seeds a chip_draws call takes, so that the deadline is checked between calls
BATCH = 8
#: paired seeds "agree" within this relative ΔE
PAIR_REL = 1e-3
WINDOW = 150
IMAX = 1500


def bank_path(out: str, config: str, assign: str, draws: str, tag: str = "") -> str:
    return os.path.join(out, f"draws_{config}_{assign}_{draws}{tag}.jsonl")


def counts_path(out: str, config: str, assign: str, draws: str) -> str:
    return os.path.join(out, f"counts_{config}_{assign}_{draws}.jsonl")


def oracle_path(out: str, config: str) -> str:
    return os.path.join(out, f"oracle_{config}.jsonl")


def load(path: str) -> dict:
    """{seed: record} of a JSONL bank (the last record of a seed wins)."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    out[rec["seed"]] = rec
    return out


def layer2(out: str, device) -> dict:
    """Each layer-2 run's verdict line; runs those whose log has no PASS
    (none yet, or a FAIL, which is run again)."""
    from hybridquantization_tpu_torch.tools import tpu_f32x3

    verdicts = {}
    for name, content, size, colors in LAYER2:
        log = os.path.join(out, f"fitness_parity_split_{name}.log")
        if not _passed(_verdict(log)):
            t0 = time.perf_counter()
            argv = ["--content", content, "--size", str(size), "--colors", str(colors), *LAYER2_ARGS]
            print(f"[layer 2 split] {name}: tpu_f32x3 {' '.join(argv)}", flush=True)
            with open(log, "w") as f, contextlib.redirect_stdout(_Tee(f)):
                rc = tpu_f32x3.main(argv, device=device)
            print(f"[layer 2 split] {name}: exit {rc}, {time.perf_counter() - t0:.1f} s", flush=True)
        verdicts[name] = _verdict(log)
    return verdicts


def _passed(verdict: str | None) -> bool:
    return bool(verdict) and verdict.startswith(f"{VERDICT} PASS")


def banks(out: str, deadline: float, device="cuda") -> None:
    import chip_draws
    from hybridquantization_tpu_torch.tools.engine_run import parse_seeds

    for config, assign, draws, seeds, counted, tag in BANKS:
        content, size, colors = CONFIGS[config][:3]
        bank = bank_path(out, config, assign, draws, tag)
        done = set(load(bank))
        todo = [s for s in parse_seeds(seeds) if s not in done]
        counted = set(parse_seeds(counted))
        t0 = time.perf_counter()
        while todo and time.time() < deadline:
            # seeds with counts and without go to separate calls
            with_counts = todo[0] in counted
            batch = [s for s in todo if (s in counted) == with_counts][:BATCH]
            argv = ["--content", content, "--size", str(size), "--colors", str(colors),
                    "--imax", str(IMAX), "--seeds", ",".join(map(str, batch)), "--draws", draws,
                    "--assign", assign, "--out", bank]
            if with_counts:
                argv += ["--counts", counts_path(out, config, assign, draws)]
            if chip_draws.main(argv, device=device) != 0:
                raise RuntimeError(f"chip_draws {' '.join(argv)} failed")
            todo = [s for s in todo if s not in batch]
        print(f"[bank] {os.path.basename(bank)}: {len(load(bank))} seeds "
              f"({time.perf_counter() - t0:.1f} s this call; {len(todo)} left)", flush=True)


def start_oracle(out: str, spec: str) -> list:
    """The oracle runs of `spec` ("config1nat:5,config2:2"), each a process
    group of its own: [(config, Popen, log file)]."""
    runs = []
    for item in filter(None, spec.split(",")):
        config, jobs = item.split(":")
        content, size, colors, _, old, last, _ = CONFIGS[config]
        path = oracle_path(out, config)
        if not os.path.exists(path):
            shutil.copyfile(os.path.join(EVIDENCE, old), path)
        log = open(f"{path}.log", "a")  # beside its bank, as the heartbeats
        cmd = [sys.executable, "-m", "hybridquantization_tpu_torch.tools.oracle_run", "--content", content,
               "--size", str(size), "--colors", str(colors), "--imax", str(IMAX), "--population", "4",
               "--seeds", f"0-{last}", "--jobs", jobs, "--dtype", "f32", "--out", path]
        runs.append((config, subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                              start_new_session=True), log))
        print(f"[oracle] {config}: {jobs} jobs -> {os.path.relpath(path, REPO)}", flush=True)
    return runs


def stop_oracle(out: str, runs: list, deadline: float) -> None:
    """Wait for the oracle runs until the deadline, then end their groups."""
    for config, proc, log in runs:
        try:
            proc.wait(timeout=max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        log.close()
        seconds = [r["seconds"] for s, r in sorted(load(oracle_path(out, config)).items())
                   if s > 9 and "seconds" in r]
        print(f"[oracle] {config}: n={len(load(oracle_path(out, config)))} on a host of "
              f"{len(os.sched_getaffinity(0))} cores (exit {proc.returncode}); new seeds' seconds {seconds}", flush=True)


def paired(bank: dict, jax_bank: dict) -> str:
    """Per-seed ΔE against the JAX bank on the seeds both hold."""
    seeds = sorted(set(bank) & set(jax_bank))
    n = len(seeds)
    if n < 3:
        return f"paired: {n} common seeds"
    a = [bank[s]["deltaE"] for s in seeds]
    b = [jax_bank[s]["deltaE"] for s in seeds]
    d = [x - y for x, y in zip(a, b)]
    mean_b = sum(b) / n
    md = sum(d) / n
    se = math.sqrt(sum((x - md) ** 2 for x in d) / (n - 1) / n)
    ma = sum(a) / n
    cov = sum((x - ma) * (y - mean_b) for x, y in zip(a, b))
    r = cov / math.sqrt(sum((x - ma) ** 2 for x in a) * sum((y - mean_b) ** 2 for y in b))
    agree = sum(abs(x - y) <= PAIR_REL * abs(y) for x, y in zip(a, b))
    return (f"paired over {n} seeds: port {ma:.4f}, JAX {mean_b:.4f}; difference {md:+.4f} ± {se:.4f} "
            f"(SE) = {md / mean_b:+.2%} ± {se / mean_b:.2%}; Pearson r {r:.3f}; "
            f"{agree}/{n} seeds within {PAIR_REL:g} relative")


def counts_table(paths: list) -> str:
    """Per file, the mean per seed and iteration of each counted series in
    windows of WINDOW iterations."""
    lines = []
    for path in paths:
        recs = list(load(path).values())
        if not recs:
            continue
        imax = len(recs[0]["accepted"])
        lines.append(f"{os.path.basename(path)} ({len(recs)} seeds), mean per iteration over seeds, "
                     f"windows of {WINDOW} iterations:")
        lines.append("  window      " + " ".join(f"{k:>11}" for k in ("accepted", "uphill", "overwritten",
                                                                      "improved")))
        for lo in range(0, imax, WINDOW):
            cells = []
            for k in ("accepted", "uphill", "overwritten", "improved"):
                tot = sum(sum(r[k][lo : lo + WINDOW]) for r in recs)
                cells.append(f"{tot / len(recs) / min(WINDOW, imax - lo):11.4f}")
            lines.append(f"  {lo + 1:>4}-{min(lo + WINDOW, imax):<6} " + " ".join(cells))
        lines.append(f"  ΔE of these seeds: mean {sum(r['deltaE'] for r in recs) / len(recs):.4f}")
    return "\n".join(lines)


def reports(out: str) -> None:
    for config, (*_, jax_bank, old_oracle, _, fp32_bank) in CONFIGS.items():
        oracle = oracle_path(out, config)
        if not os.path.exists(oracle):
            oracle = os.path.join(EVIDENCE, old_oracle)
        jax_path = os.path.join(EVIDENCE, jax_bank)
        runs = [("fp32_device_full", os.path.join(out, fp32_bank))]
        runs += [(f"{a}_{d}{t}", bank_path(out, c, a, d, t)) for c, a, d, _, _, t in BANKS if c == config]
        for label, path in runs:
            if not load(path):
                continue
            for side, against in (("jax", jax_path), ("oracle", oracle)):
                verdict, gap, sigma = report(path, against,
                                             os.path.join(out, f"report_{config}_{label}_vs_{side}.txt"))
                print(f"[report] {config} {label} vs {side} (n={len(load(path))}, "
                      f"{os.path.basename(against)} n={len(load(against))}): gap {gap:+.2%} ± "
                      f"{sigma:.2%}; {verdict}", flush=True)
            if label.endswith("_jax"):
                text = paired(load(path), load(jax_path))
                with open(os.path.join(out, f"paired_{config}_{label}.txt"), "w") as f:
                    f.write(text + "\n")
                print(f"[paired] {config} {label}: {text}", flush=True)
        # e: the fp32 reruns against the fp32 bank they repeat
        rerun, full = load(bank_path(out, config, "fp32", "device")), load(os.path.join(out, fp32_bank))
        same = [s for s in rerun if s in full and rerun[s]["deltaE"] == full[s]["deltaE"]]
        print(f"[counts] {config}: fp32 device reruns equal to the bank bit for bit on "
              f"{len(same)}/{len(rerun)} seeds", flush=True)
        table = counts_table([counts_path(out, config, "fp32", "device"),
                              counts_path(out, config, "split", "device")])
        if table:
            with open(os.path.join(out, f"counts_{config}.txt"), "w") as f:
                f.write(table + "\n")
            print(table, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="layer2,banks,reports")
    ap.add_argument("--deadline", type=float, default=3300.0, help="seconds from the start")
    ap.add_argument("--oracle", default="", help="e.g. config1nat:5,config2:2 (jobs per bank)")
    ap.add_argument("--out", default=C2, help="the evidence directory (a copy of docs/evidence_h100/c2)")
    args = ap.parse_args(argv)
    deadline = time.time() + args.deadline
    import torch

    if not torch.cuda.is_available():
        print("chip_c2: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.tools import device_line

    dev = setup_device("cuda")
    print(f"{device_line(dev)}; host cores (nproc) {len(os.sched_getaffinity(0))}", flush=True)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    stages = set(args.stages.split(","))
    runs = start_oracle(out, args.oracle)
    verdicts = {}
    try:
        if "layer2" in stages:
            verdicts = layer2(out, dev)
        if "banks" in stages:
            banks(out, deadline, dev)
    except BaseException:
        stop_oracle(out, runs, time.time())
        raise
    stop_oracle(out, runs, deadline)
    if "reports" in stages:
        reports(out)
    failed = {name: v for name, v in verdicts.items() if not _passed(v)}
    if failed:
        print(f"chip_c2: layer 2 with the split fitness did not pass: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
