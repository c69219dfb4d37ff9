"""Seed-by-seed pairing of two layer-3 banks, and the paired gate.

    python -m hybridquantization_tpu_torch.tools.paired BANK REF [--labels port,JAX] [--out TXT]
        [--verdict] [--bitwise] [--basins THIRD] [--series BANK_SERIES THIRD_SERIES [--series-rel 1e-6]]

Two banks judged by the same oracle judge (`engine_run`'s records) that
share seeds, and on each seed the same draw stream, pair seed by seed: the
port on JAX's own stream (`chip_draws.py --draws jax`) against the JAX
TPU engine's bank, or two JAX banks that differ only in their arithmetic.
On the common seeds, with d = BANK - REF per seed:

  - the two means, the mean of d with its standard error (SE, the sd of d
    over sqrt(n): the uncertainty of the mean, not the spread of the
    seeds), and the per-seed sd of d (the spread);
  - Pearson r of the two banks;
  - the seeds within PAIR_REL relative of REF, and the rest, the diverged
    seeds: how many of them BANK ends higher on, the two-sided exact sign
    test over them, and their median relative difference d / REF.

REF may name several files: their seeds are pooled. `--basins THIRD`
adds, for each seed on which BANK diverged from REF, where a third bank
lands (`basins`): with BANK, with REF or neither, as fault C2's verdict
rule reads JAX's engine off the TPU against the port and the TPU.
`--series` adds the first iteration at which the two banks' per-iteration
best errors part by more than `--series-rel` (`parting`).

The gate (`Paired.fault`): the mean of d lies more than SIGMAS SE from
zero AND the sign test over the diverged seeds gives p < SIGN_P. An offset
moves both; arithmetic chaos that parts seeds both ways, with a few large
tails, moves at most the first. So the gate is blind to a fault that
hits a minority of seeds hard (a port 5% worse on 10 of 24 seeds passes
it, `tests/test_torch_paired.py`): that is the shape of fault C2's
residual, and of an acceptance or convergence bug that bites on some
seeds only. It sits beside the unpaired gate of `chip_parity.py` and
cannot replace it.

The same-function gate (`Paired.same_function_fault`) is stricter: the
mean of d lies more than SIGMAS SE from zero OR the sign test gives
p < SIGN_P. It holds the port to a bank of JAX's engine computing the
port's own function off the TPU (`tests/jax_cpu_engine.py --branch xla
--precision highest` against the port's fp32 engine on JAX's streams),
where the two engines are meant to agree seed by seed: there a minority of
seeds hit hard the same way is a fault, which the sign test sees. Its
verdict (`Paired.verdict`, `--verdict`): "the port is JAX's engine" when
at least AGREE_SHARE of the seeds agree and neither test faults; "port
fault" when one does; "in between" otherwise. Standard library only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
from dataclasses import dataclass

#: paired seeds "agree" within this relative ΔE; the rest have diverged
PAIR_REL = 1e-3
#: the gate: |mean difference| above this many SE ...
SIGMAS = 2.0
#: ... and the sign test over the diverged seeds below this p
SIGN_P = 0.05
#: the same-function verdict "the port is JAX's engine" needs at least this share of the seeds agreeing
AGREE_SHARE = 2 / 3


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


def sign_test(k: int, n: int) -> float:
    """Two-sided exact sign test: P(a count at least as far from n/2 as k)
    for Binomial(n, 1/2); 1.0 for n = 0."""
    if n == 0:
        return 1.0
    tail = min(k, n - k)
    return min(1.0, 2 * sum(math.comb(n, i) for i in range(tail + 1)) / 2**n)


@dataclass(frozen=True)
class Paired:
    seeds: tuple
    mean_a: float
    mean_b: float
    diff: float          # mean of d = a - b
    se: float            # its standard error
    sd: float            # per-seed sd of d
    r: float             # Pearson r (nan when a side is constant)
    agree: int           # seeds with |d| <= PAIR_REL * |b|
    higher: int          # diverged seeds on which a > b
    sign_p: float        # two-sided sign test over the diverged seeds
    median_rel: float    # median d / b over the diverged seeds (nan if none)

    @property
    def n(self) -> int:
        return len(self.seeds)

    @property
    def diverged(self) -> int:
        return self.n - self.agree

    @property
    def z(self) -> float:
        """The mean difference in SE (0 when both are 0)."""
        return self.diff / self.se if self.se else (0.0 if self.diff == 0 else math.copysign(math.inf, self.diff))

    @property
    def fault(self) -> bool:
        return abs(self.z) > SIGMAS and self.sign_p < SIGN_P

    @property
    def same_function_fault(self) -> bool:
        """The gate for two engines of one function: either test faults."""
        return abs(self.z) > SIGMAS or self.sign_p < SIGN_P

    @property
    def verdict(self) -> str:
        """The same-function verdict: "the port is JAX's engine", "port
        fault" or "in between"."""
        if self.same_function_fault:
            return "port fault"
        return "the port is JAX's engine" if self.agree >= AGREE_SHARE * self.n else "in between"

    def rule_text(self) -> str:
        """The same-function gate and verdict as a line."""
        return (f"same-function gate: {'FAULT' if self.same_function_fault else 'pass'}; verdict: "
                f"{self.verdict} (needs >= {AGREE_SHARE:.3g} of the seeds within {PAIR_REL:g}, "
                f"|mean| <= {SIGMAS:g} SE, sign-test p >= {SIGN_P:g})")

    def text(self, a: str = "port", b: str = "JAX") -> str:
        mb = self.mean_b
        median = "none diverged" if self.diverged == 0 else f"median relative difference {self.median_rel:+.2%}"
        return (f"paired over {self.n} seeds: {a} {self.mean_a:.4f}, {b} {mb:.4f}; difference "
                f"{self.diff:+.4f} ± {self.se:.4f} (SE) = {self.diff / mb:+.2%} ± {self.se / mb:.2%} (SE), "
                f"{self.z:+.2f} SE; per-seed sd {self.sd:.4f} = {self.sd / mb:.2%}; Pearson r {self.r:.3f}; "
                f"{self.agree}/{self.n} seeds within {PAIR_REL:g} relative; diverged {self.diverged}, "
                f"{a} higher on {self.higher}: sign-test p {self.sign_p:.2f}, {median}")


def pair(bank: dict, ref: dict) -> Paired | None:
    """The pairing of `bank` with `ref` ({seed: record} with "deltaE") on
    the seeds both hold; None below 3 common seeds."""
    seeds = tuple(sorted(set(bank) & set(ref)))
    n = len(seeds)
    if n < 3:
        return None
    a = [bank[s]["deltaE"] for s in seeds]
    b = [ref[s]["deltaE"] for s in seeds]
    d = [x - y for x, y in zip(a, b)]
    sd = statistics.stdev(d)
    ma, mb = statistics.fmean(a), statistics.fmean(b)
    sxx = sum((x - ma) ** 2 for x in a) * sum((y - mb) ** 2 for y in b)
    r = sum((x - ma) * (y - mb) for x, y in zip(a, b)) / math.sqrt(sxx) if sxx > 0 else math.nan
    div = [(x, y) for x, y in zip(a, b) if abs(x - y) > PAIR_REL * abs(y)]
    higher = sum(x > y for x, y in div)
    return Paired(seeds=seeds, mean_a=ma, mean_b=mb, diff=statistics.fmean(d), se=sd / math.sqrt(n), sd=sd,
                  r=r, agree=n - len(div), higher=higher, sign_p=sign_test(higher, len(div)),
                  median_rel=statistics.median((x - y) / y for x, y in div) if div else math.nan)


def paired(bank: dict, ref: dict, a: str = "port", b: str = "JAX") -> str:
    """`pair`'s line, or the count of common seeds when there are too few."""
    p = pair(bank, ref)
    return p.text(a, b) if p else f"paired: {len(set(bank) & set(ref))} common seeds"


def bit_equal(bank: dict, ref: dict) -> str:
    """On how many common seeds the two banks' (deltaE, mse) are equal bit
    for bit, and the seeds that differ: a rerun against its committed bank."""
    seeds = sorted(set(bank) & set(ref))
    differ = [s for s in seeds if (bank[s]["deltaE"], bank[s]["mse"]) != (ref[s]["deltaE"], ref[s]["mse"])]
    return f"bit-equal (deltaE, mse) on {len(seeds) - len(differ)} of {len(seeds)} common seeds; differ: {differ}"


def basins(bank: dict, ref: dict, third: dict) -> list:
    """Where a third bank lands on each seed that `bank` (P) and `ref` (T)
    both hold, `third` (J) holds too, and P diverged from T on (|P - T| >
    PAIR_REL * T): [(seed, P, T, J, "with port" if |J - P| <= PAIR_REL * P,
    else "with TPU" if |J - T| <= PAIR_REL * T, else "neither")], by seed."""
    rows = []
    for s in sorted(set(bank) & set(ref) & set(third)):
        p, t, j = bank[s]["deltaE"], ref[s]["deltaE"], third[s]["deltaE"]
        if abs(p - t) <= PAIR_REL * abs(t):
            continue
        where = ("with port" if abs(j - p) <= PAIR_REL * abs(p)
                 else "with TPU" if abs(j - t) <= PAIR_REL * abs(t) else "neither")
        rows.append((s, p, t, j, where))
    return rows


def basin_table(rows: list, a: str = "port", b: str = "TPU", c: str = "JAX off the TPU") -> str:
    """`basins`' rows as text, with the count of each class."""
    lines = [f"seed  {a:>10} {b:>10} {c:>16}  where"]
    lines += [f"{s:>4}  {p:10.6f} {t:10.6f} {j:16.6f}  {w}" for s, p, t, j, w in rows]
    counts = {w: sum(r[4] == w for r in rows) for w in ("with port", "with TPU", "neither")}
    lines.append(f"{len(rows)} diverged seeds: " + ", ".join(f"{w} {n}" for w, n in counts.items()))
    return "\n".join(lines)


def parting(a, b, rel: float = 1e-6):
    """The first iteration (1-based) at which two per-iteration series part
    by more than `rel` relative, or None if they never do."""
    for i, (x, y) in enumerate(zip(a, b)):
        if abs(x - y) > rel * abs(y):
            return i + 1
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bank")
    ap.add_argument("ref", nargs="+", help="one bank, or several whose seeds are pooled")
    ap.add_argument("--labels", default="port,JAX", help="the two banks' names in the line")
    ap.add_argument("--basins", default="", help="a third bank: where it lands on BANK's diverged seeds")
    ap.add_argument("--series", nargs=2, default=None, metavar=("BANK_SERIES", "THIRD_SERIES"),
                    help="per-iteration best-error series of BANK and the third bank: where they part")
    ap.add_argument("--series-rel", type=float, default=1e-6, help="--series: the relative gap that parts")
    ap.add_argument("--bitwise", action="store_true", help="add the seeds on which the banks are bit-equal")
    ap.add_argument("--verdict", action="store_true",
                    help="add the same-function verdict (BANK and REF compute one function)")
    ap.add_argument("--out", default="", help="also write the text here")
    args = ap.parse_args(argv)
    a, b = args.labels.split(",")
    missing = [p for p in [args.bank, *args.ref] if not os.path.exists(p)]
    if missing:
        ap.error(f"no bank {missing}")
    bank, ref = load(args.bank), {s: r for path in args.ref for s, r in load(path).items()}
    text = paired(bank, ref, a, b)
    p = pair(bank, ref) if args.verdict else None
    if p:
        text += "\n" + p.rule_text()
    if args.bitwise:
        text += "\n" + bit_equal(bank, ref)
    if args.basins:
        text += "\n" + basin_table(basins(bank, ref, load(args.basins)), a, b)
    if args.series:
        sa, sb = (load(path) for path in args.series)
        parts = {s: parting(sa[s]["best_error"], sb[s]["best_error"], args.series_rel)
                 for s in sorted(set(sa) & set(sb))}
        rel = f"{args.series_rel:g}".replace("e-0", "e-")  # 1e-6, not 1e-06
        text += (f"\nfirst iteration at which the best-error series part by > {rel} relative "
                 "(None: never), per seed: " + ", ".join(f"{s}: {i}" for s, i in parts.items()))
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
