#!/usr/bin/env python3
"""Fault C2's diagnostics on one GPU, resumable, into docs/evidence_h100/c2/.

    python3 chip_c2.py [--stages layer2,fingerprint,banks,reports] [--deadline SECONDS]
                       [--oracle config1nat:5,config2:2] [--out DIR]

Run from the root of a checkout. ROADMAP fault C2: the port's annealed mean
ΔE sits above the JAX TPU engine's at config-1 natural (512x512, K=16) and
config-2 (1024x1024, K=64, smooth). Stages:

  layer2   (a) layer 2 with the TPU's f32x3 fitness emulated
           (`tools.tpu_f32x3`: split_assign, then B2) at config-1 and
           config-2, smooth and natural, `fitness_parity`'s protocol (12
           batches of 4 random palettes) against the f64 oracle: fitness
           gap and split_assign's flips; one log each;
  fingerprint
           layer 2 with the whole TPU fitness emulated (split_assign and
           B2's split mode, `tpu_f32x3 --conv split`) at the three
           configurations with a TPU layer-2 log (`FINGERPRINT`); then, per
           palette (the same `default_rng(7)` draws on both sides, the
           tie-stress batch 0 left out), |TPU gap - port gap| of the "rel
           fitness gap" lines, for the port's fp32 fitness (its layer-2 logs in
           docs/evidence_h100/), split_assign with fp32 B2 (layer2 above)
           and the whole emulation, and, where its log is in the directory
           (`fitness_parity_jaxcpu_<config>.log`, made on a CPU by
           `tests/jax_cpu_layer2.py`), the JAX engine's own f32x3 fitness
           off the TPU, with |whole emulation - JAX on the CPU| beside
           them: one `fingerprint_<config>.txt` each, with the max and
           median of each column; no anneal, no seed noise;
  banks    through `chip_draws.py` (imax 1500, pop 4), in `BANKS` order:
           (b) `--fitness split --draws device`, config-1 natural seeds
               0-191 and config-2 seeds 0-95, seeds 0-23 with `--counts`;
           (e) the fp32 engine's seeds 0-23 again with `--counts` (the
               same runs as the fp32 banks in this directory), last;
           (c) `--fitness fp32 --draws jax` and (d) `--fitness split
               --draws jax`, seeds 0-95 at each configuration, which pair seed by
               seed with the JAX TPU engine's banks, and (c') the fp32
               engine on JAX's streams of seeds 96-191, which no JAX bank
               holds;
           (f) the fp32 engine's seeds 0-7 at config-1 natural once more
               (`_rerun`), which must equal bank (e) bit for bit;
           (g) the whole emulation (`--fitness f32x3`) on JAX's streams,
               seeds 0-95 at each configuration, paired with the JAX banks;
  reports  every bank against the JAX TPU bank and the oracle bank by the
           frozen `tools/parity_report.py` (`report_<bank>_vs_jax.txt`,
           `report_<bank>_vs_oracle_n<seeds the oracle holds>.txt`, so a
           grown oracle adds reports and keeps the earlier ones); for (c),
           (d) and (g) the
           paired per-seed difference from the JAX bank (mean ± SE),
           Pearson r and the seeds within 1e-3 relative; the counts by
           window of 150 iterations, fp32 beside split; (f) against (e).

`--oracle CONFIG:JOBS,...` runs the oracle's own seeds on this host's CPU
beside the card's work (`tools.oracle_run`, one process group, stopped at
the deadline, its log beside its bank): config-1 natural to seed 95 and
config-2 to seed 47, each bank starting as a copy of its `docs/evidence/`
bank. A bank seed starts only before `--deadline` seconds (from the start
of the call) have passed; every stage resumes from the files in `--out`
(default docs/evidence_h100/c2; a run whose outputs must be fetched from
another directory copies the evidence there first). Prints nproc first.
Exits non-zero on an error, on a layer-2 run that does not PASS (run
again on resume), on a rerun that differs from its bank, or without a
CUDA device.

Imports torch, numpy, scipy (the oracle), the standard library and the
port; never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

from chip_parity import VERDICT, _Tee, _verdict, report

REPO = os.path.dirname(os.path.abspath(__file__))
EVIDENCE = os.path.join(REPO, "docs", "evidence")
H100 = os.path.join(REPO, "docs", "evidence_h100")
C2 = os.path.join(H100, "c2")

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
#: the configurations with a TPU layer-2 log (docs/evidence/): name, content, size, colors, log
FINGERPRINT = (("config1", "smooth", 512, 16, "fitness_parity_config1_r04.log"),
               ("config2", "smooth", 1024, 64, "fitness_parity_config2_r04.log"),
               ("config2nat", "natural", 1024, 64, "fitness_parity_config2nat_r05.log"))
#: (config, chip_draws --fitness, draws, seeds, seeds with --counts, file tag), in the order they run;
#: the fp32 banks on JAX's streams of seeds 96-191, which no JAX bank holds,
#: tell a low sample of streams from a property of the stream; a bank tagged
#: "_rerun" repeats seeds of its untagged bank and must equal it bit for bit
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
    ("config1nat", "fp32", "device", "0-7", "", "_rerun"),
    ("config1nat", "f32x3", "jax", "0-95", "", ""),
    ("config2", "f32x3", "jax", "0-95", "", ""),
)
#: seeds a chip_draws call takes, so that the deadline is checked between calls
BATCH = 8
#: paired seeds "agree" within this relative ΔE
PAIR_REL = 1e-3
WINDOW = 150
IMAX = 1500


def bank_path(out: str, config: str, fitness: str, draws: str, tag: str = "") -> str:
    return os.path.join(out, f"draws_{config}_{fitness}_{draws}{tag}.jsonl")


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


def _layer2_run(log: str, name: str, content: str, size: int, colors: int, conv: str, device) -> str:
    """The verdict line of `log`, a layer-2 run with the emulated fitness
    (B2 by `conv`); runs it when the log has no PASS (none yet, or a FAIL,
    which is run again)."""
    from hybridquantization_tpu_torch.tools import tpu_f32x3

    if not _passed(_verdict(log)):
        t0 = time.perf_counter()
        argv = ["--content", content, "--size", str(size), "--colors", str(colors), *LAYER2_ARGS,
                "--conv", conv]
        print(f"[layer 2 {conv}] {name}: tpu_f32x3 {' '.join(argv)}", flush=True)
        with open(log, "w") as f, contextlib.redirect_stdout(_Tee(f)):
            rc = tpu_f32x3.main(argv, device=device)
        print(f"[layer 2 {conv}] {name}: exit {rc}, {time.perf_counter() - t0:.1f} s", flush=True)
    return _verdict(log)


def layer2(out: str, device) -> dict:
    """Each layer-2 run's verdict line (split_assign, fp32 B2)."""
    return {name: _layer2_run(os.path.join(out, f"fitness_parity_split_{name}.log"), name, content, size,
                              colors, "fp32", device)
            for name, content, size, colors in LAYER2}


def parse_gaps(path: str) -> dict:
    """{(batch, member): rel fitness gap} of a layer-2 log's batch lines."""
    gaps = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"batch (\d+): rel fitness gap ((?:\S+ )+) assign flips", line)
            if m:
                for member, gap in enumerate(m.group(2).split()):
                    gaps[(int(m.group(1)), member)] = float(gap)
    return gaps


def fingerprint_table(name: str, tpu_log: str, ports: dict, pairs: tuple = ()) -> tuple[str, dict]:
    """Per palette of batches 1 and up that the TPU's log and every log of
    `ports` ({column: path}) hold, |TPU gap - port gap|, and for each (a, b)
    of `pairs` (two columns) |a gap - b gap|; then each column's max and
    median. Returns (text, {column or "a-b": (max, median)})."""
    tpu = parse_gaps(tpu_log)
    cols = {col: parse_gaps(path) for col, path in ports.items()}
    keys = sorted(k for k in tpu if k[0] > 0 and all(k in c for c in cols.values()))
    lines = [f"fingerprint {name}: |TPU gap - port gap| per palette, the \"rel fitness gap\" against the "
             f"f64 oracle of fitness_parity's protocol (palettes from default_rng(7) on both sides; the "
             f"tie-stress batch 0 left out); TPU {os.path.basename(tpu_log)}, ports "
             + ", ".join(f"{c} {os.path.relpath(p, REPO)}" for c, p in ports.items())
             + f"; {len(keys)} palettes",
             "batch member  TPU gap   " + " ".join(f"{c:>10} |TPU-{c}|" for c in cols)
             + "".join(f" |{a}-{b}|" for a, b in pairs)]
    for b, m in keys:
        lines.append(f"{b:5d} {m:6d}  {tpu[(b, m)]:.2e}  " + " ".join(
            f"{c[(b, m)]:10.2e} {abs(tpu[(b, m)] - c[(b, m)]):10.2e}" for c in cols.values())
            + "".join(f" {abs(cols[p][(b, m)] - cols[q][(b, m)]):{len(p) + len(q) + 3}.2e}" for p, q in pairs))
    diffs = {col: [abs(tpu[k] - c[k]) for k in keys] for col, c in cols.items()}
    diffs.update({f"{a}-{b}": [abs(cols[a][k] - cols[b][k]) for k in keys] for a, b in pairs})
    stats = {col: (max(d), statistics.median(d)) if d else (math.nan, math.nan) for col, d in diffs.items()}
    lines.append("|TPU - port|: " + "; ".join(f"{col} max {stats[col][0]:.3e} median {stats[col][1]:.3e}"
                                              for col in cols)
                 + "".join(f"; |{a} - {b}| max {stats[f'{a}-{b}'][0]:.3e} median {stats[f'{a}-{b}'][1]:.3e}"
                           for a, b in pairs))
    return "\n".join(lines), stats


def fingerprint(out: str, device) -> dict:
    """Layer 2 with the whole emulated fitness at FINGERPRINT's
    configurations, then each one's fingerprint file: {config: (verdict,
    {column: (max, median)})}."""
    results = {}
    for name, content, size, colors, tpu_log in FINGERPRINT:
        log = os.path.join(out, f"fitness_parity_f32x3_{name}.log")
        verdict = _layer2_run(log, name, content, size, colors, "split", device)
        ports = {"fp32": os.path.join(H100, f"fitness_parity_{name}.log"),
                 "split": os.path.join(out, f"fitness_parity_split_{name}.log"), "f32x3": log}
        jax_cpu = os.path.join(out, f"fitness_parity_jaxcpu_{name}.log")
        pairs = ()
        if os.path.exists(jax_cpu):
            ports["jax_cpu"], pairs = jax_cpu, (("f32x3", "jax_cpu"),)
        text, stats = fingerprint_table(name, os.path.join(EVIDENCE, tpu_log), ports, pairs)
        with open(os.path.join(out, f"fingerprint_{name}.txt"), "w") as f:
            f.write(text + "\n")
        print(f"[fingerprint] {name}: {text.splitlines()[-1]}", flush=True)
        results[name] = (verdict, stats)
    return results


def _passed(verdict: str | None) -> bool:
    return bool(verdict) and verdict.startswith(f"{VERDICT} PASS")


def banks(out: str, deadline: float, device="cuda") -> None:
    import chip_draws
    from hybridquantization_tpu_torch.tools.engine_run import parse_seeds

    for config, fitness, draws, seeds, counted, tag in BANKS:
        content, size, colors = CONFIGS[config][:3]
        bank = bank_path(out, config, fitness, draws, tag)
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
                    "--fitness", fitness, "--out", bank]
            if with_counts:
                argv += ["--counts", counts_path(out, config, fitness, draws)]
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


def reruns(out: str) -> bool:
    """Each "_rerun" bank against the bank it repeats, ΔE bit for bit, one
    `rerun_<bank>.txt` each; True when every seed is equal."""
    ok = True
    for config, fitness, draws, *_, tag in BANKS:
        if tag != "_rerun":
            continue
        rerun, bank = load(bank_path(out, config, fitness, draws, tag)), load(bank_path(out, config, fitness, draws))
        same = [s for s in sorted(rerun) if s in bank and rerun[s]["deltaE"] == bank[s]["deltaE"]]
        text = (f"{config} {fitness} {draws}: seeds {sorted(rerun)} run again, ΔE equal to "
                f"{os.path.basename(bank_path(out, config, fitness, draws))} bit for bit on "
                f"{len(same)}/{len(rerun)} seeds")
        with open(os.path.join(out, f"rerun_{config}_{fitness}_{draws}.txt"), "w") as f:
            f.write(text + "\n")
        print(f"[rerun] {text}", flush=True)
        ok &= len(same) == len(rerun)
    return ok


def reports(out: str) -> None:
    for config, (*_, jax_bank, old_oracle, _, fp32_bank) in CONFIGS.items():
        oracle = oracle_path(out, config)
        if not os.path.exists(oracle):
            oracle = os.path.join(EVIDENCE, old_oracle)
        jax_path = os.path.join(EVIDENCE, jax_bank)
        runs = [("fp32_device_full", os.path.join(out, fp32_bank))]
        runs += [(f"{a}_{d}{t}", bank_path(out, c, a, d, t)) for c, a, d, _, _, t in BANKS
                 if c == config and t != "_rerun"]
        for label, path in runs:
            if not load(path):
                continue
            for side, against in (("jax", jax_path), (f"oracle_n{len(load(oracle))}", oracle)):
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
    ap.add_argument("--stages", default="layer2,fingerprint,banks,reports")
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
        if "fingerprint" in stages:
            verdicts.update({f"{name} f32x3": v for name, (v, _) in fingerprint(out, dev).items()})
        if "banks" in stages:
            banks(out, deadline, dev)
    except BaseException:
        stop_oracle(out, runs, time.time())
        raise
    stop_oracle(out, runs, deadline)
    same = True
    if "reports" in stages:
        reports(out)
        same = reruns(out)
    failed = {name: v for name, v in verdicts.items() if not _passed(v)}
    if failed:
        print(f"chip_c2: layer 2 with the emulated fitness did not pass: {failed}", file=sys.stderr)
    if not same:
        print("chip_c2: a rerun differs from its bank", file=sys.stderr)
    return 0 if same and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
