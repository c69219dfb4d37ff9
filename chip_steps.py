#!/usr/bin/env python3
"""The port's anneal on the card and on the CPU, stepped side by side, to the
first decision that differs.

    python3 chip_steps.py [--seeds 25,30,35,2,13] [--size 512 --colors 16
                           --imax 1500 --until N --to-end --jobs N
                           --series P_SERIES.jsonl ... --bank P.jsonl --cpu-bank CPU.jsonl
                           --out docs/evidence_h100/c2/cardsteps_config1nat.jsonl --cpu]

Two copies of the port's `swasa.loop.make_step` run one iteration at a
time, as `loop.run_chunk` runs them: "card" over the engine's fitness on
the card (the B1 and B2 kernels) and "plain" over the same fitness on the
CPU (the kernels' plain versions, the anneal of `chip_draws.py --draws jax
--cpu`). Both start from the same palettes on the JAX engine's draw stream
for `PRNGKey(seed)` (`tools.jax_draws`, one stream a side, checked equal
every iteration), and each follows its own decisions. Every iteration both
sides' decisions (acceptance and convergence keep per member, the
convergence source, the best update) are recomputed from their numbers by
`tools.steps.decisions`, with the port's keep probability, and checked
against what the step did to the state. At the first iteration where a
decision differs the script prints both sides' errors of the proposals
involved, their margins and the f64 oracle's fitness (`tests/oracle.py`)
of each side's proposals, current palettes and best palette, classifies
the parting (`tools.steps.classify`: "arithmetic" or "logic"), says which
side the oracle's recomputed decision takes, and stops; with `--to-end`
both sides run on to `--imax`, and the record also holds each side's final
ΔE beside its bank's (`--bank`, the card bank on JAX's streams; `--cpu-bank`,
`chip_draws.py --draws jax --cpu`'s). The card side's per-iteration best
errors are held to its bank's series (`--series`, `chip_draws.py
--series` files). One JSON line a seed is appended to `--out`.

The image is config-1's natural content (CONTENT), the content of the
banks the defaults name; --size, --colors and --imax shrink it for a
rehearsal. `--jobs N` runs the seeds in N processes of this script, each
with one intra-op CPU thread (the plain side's), sharing the card.
Exits non-zero without a CUDA device unless --cpu puts both sides on the
CPU (a rehearsal: they then never part). Imports torch, numpy, scipy (the
oracle), the standard library and the port; never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
C2 = os.path.join(REPO, "docs", "evidence_h100", "c2")
SIDES = ("card", "plain")
#: the image content of config-1 natural, the banks' (and their series') configuration
CONTENT = "natural"
SERIES = [os.path.join(C2, f) for f in ("series_config1nat_fp32_jax.jsonl",
                                        "series_config1nat_fp32_jax_24-95.jsonl")]
#: intra-op CPU threads a process: the plain side's, so seeds run side by side on the card host's cores
THREADS = 1


class Side:
    """One stepped anneal: the engine's population fitness on `device`
    (passed through `wrap` when given), `make_step` over it, and its own
    copy of the JAX engine's draw stream for `seed`."""

    def __init__(self, name, img, cfg, device, seed: int, wrap=None):
        from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness, setup_device
        from hybridquantization_tpu_torch.scielab.filters import build_filters
        from hybridquantization_tpu_torch.swasa import loop
        from hybridquantization_tpu_torch.tools import jax_draws

        self.name, self.cfg = name, cfg
        self.dev = setup_device(device)
        fit = make_population_fitness(_make_context(img, build_filters(), cfg, self.dev), cfg)
        fit = wrap(fit) if wrap is not None else fit

        def fitness(p):
            self.proposals = p
            self.errors, usage = fit(p)
            return self.errors, usage

        sw = cfg.swasa
        self.step_fn = loop.make_step(fitness, sw)
        self.stream = jax_draws.engine_draws(seed, sw.population, sw.num_colors)
        self.start = next(self.stream).copy()
        self.state = loop.init_state(torch.Generator(device=self.dev), fitness, sw,
                                     torch.from_numpy(self.start.copy()).to(self.dev))
        self.best = []  # each iteration's best error, as `chip_draws.py --series` records it

    def step(self, ite: int, draws: dict) -> dict:
        """Take iteration `ite` on `draws`: this iteration's numbers as
        `steps.decisions` takes them, the decisions recomputed from them
        ("decisions", "margins"), whether the step took them ("took"), and
        the palettes the oracle would judge."""
        from hybridquantization_tpu_torch.swasa import schedule
        from hybridquantization_tpu_torch.tools import steps

        sw = self.cfg.swasa
        it = torch.tensor(ite, dtype=torch.int32, device=self.dev)
        old = self.state
        new, _ = self.step_fn(old, it, {k: torch.from_numpy(v.copy()).to(self.dev) for k, v in draws.items()})
        keep_p = schedule.keep_probability(it, sw.conv_delay, sw.conv_spread, sw.imax)
        n = {"errors": self.errors.cpu().numpy(), "current": old.current_errors.cpu().numpy(),
             "temperature": np.float32(new.temperature.item()), "keep_p": np.float32(keep_p.item()),
             "best": np.float32(old.best_error.item())}
        n["decisions"], n["margins"] = steps.decisions(
            n["errors"], n["current"], n["temperature"], draws["acc"], draws["conv"], n["keep_p"], n["best"],
            sw.convergence and sw.population > 1)
        n["took"] = took(n, new.current_errors.cpu().numpy(), np.float32(new.best_error.item()))
        n["proposals"] = self.proposals.cpu().numpy()
        n["colors"], n["best_colors"] = old.colors.cpu().numpy(), old.best_colors.cpu().numpy()
        self.state = new
        self.best.append(float(new.best_error))
        return n


def took(n: dict, current, best) -> bool:
    """Whether a step that left `current` errors and `best` error took the
    decisions recomputed in `n`."""
    d, e = n["decisions"], n["errors"]
    want = np.where(d["accept"], e, n["current"])
    if d["source"] is not None:
        want = np.where(d["keep"], want, e[d["source"]])
    want_best = e[d["best"]] if d["best"] is not None else n["best"]
    return bool(np.array_equal(want, current) and np.float32(want_best) == best)


def parting(ite: int, a: dict, b: dict, draws: dict, judge, convergence: bool) -> dict:
    """The first differing decision at iteration `ite`, classified, with
    the oracle's side of it from each side's state (judge: `steps.Judge`)."""
    from hybridquantization_tpu_torch.tools import steps

    verdict = steps.classify(a, b, draws["acc"], draws["conv"], convergence)
    names = verdict["decisions"]
    rec = {"iteration": ite, "decisions": names, "class": verdict["class"], "rel_gap": verdict["rel_gap"],
           "card_state_plain_errors_flips": verdict["flip_a"],
           "plain_state_card_errors_flips": verdict["flip_b"],
           "max_proposal_gap": float(np.abs(a["proposals"] - b["proposals"]).max())}
    for name, n in zip(SIDES, (a, b)):
        rec[name] = {k: n[k] for k in ("decisions", "errors", "current", "temperature", "keep_p", "best",
                                       "margins")}
    rec["oracle"] = {}
    for name, n in zip(SIDES, (a, b)):
        view = steps.oracle_view(judge, n["proposals"], n["colors"], n["best_colors"], n["temperature"],
                                 draws["acc"], draws["conv"], n["keep_p"], convergence)
        side = steps.oracle_side(view["decisions"], a["decisions"], b["decisions"], names)
        view["with"] = {"a": "card", "b": "plain"}.get(side, side)
        rec["oracle"][f"from_{name}_state"] = view
    sides = {v["with"] for v in rec["oracle"].values()}
    rec["oracle_side"] = sides.pop() if len(sides) == 1 else "split"
    return rec


def jsonable(x):
    """`x` with numpy arrays and scalars as lists and Python numbers."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def step_pair(img, cfg, seed: int, devices=("cuda", "cpu"), until: int = 0, to_end: bool = False,
              wraps=(None, None), ref_series=None, log=print) -> dict:
    """Step the two sides of `seed` to their first differing decision
    (through `until`, default imax), and with `to_end` on to imax.
    ref_series: the card side's bank series (a list), or None. Returns the
    seed's record: "through", the iterations stepped; "parting", None when
    no decision differed, else `parting`'s record; "card_series", how far
    the card side's best errors follow ref_series; "final_deltaE" of each
    side when stepped to imax."""
    from hybridquantization_tpu_torch.tools import steps

    sw = cfg.swasa
    conv = sw.convergence and sw.population > 1
    t0 = time.time()
    a, b = (Side(n, img, cfg, d, seed, w) for n, d, w in zip(SIDES, devices, wraps))
    if not np.array_equal(a.start, b.start):
        raise RuntimeError("the start palettes differ")
    start = {n: s.state.current_errors.cpu().numpy() for n, s in zip(SIDES, (a, b))}
    log(f"seed {seed}: start palettes equal; errors card {start['card']} plain {start['plain']}")
    last = min(until or sw.imax, sw.imax)
    found, judge, ite = None, None, 0
    for ite in range(1, (sw.imax if to_end else last) + 1):
        draws = next(a.stream), next(b.stream)
        if not all(np.array_equal(draws[0][k], draws[1][k]) for k in draws[0]):
            raise RuntimeError(f"iteration {ite}: the draws differ")
        na, nb = a.step(ite, draws[0]), b.step(ite, draws[0])
        if found is None and ite <= last:
            unfollowed = [s for s, n in zip(SIDES, (na, nb)) if not n["took"]]
            if unfollowed:
                found = {"iteration": ite, "class": "recompute", "decisions": [],
                         "note": f"the step of {unfollowed} did not take its recomputed decisions"}
            elif steps.differing(na["decisions"], nb["decisions"]):
                judge = judge or steps.Judge(img)
                found = parting(ite, na, nb, draws[0], judge, conv)
            if found is not None:
                report(seed, found, log)
                if not to_end:
                    break
        if ite % 100 == 0:
            log(f"seed {seed} iteration {ite}: " + ("decisions equal so far; max relative error difference "
                f"{float(np.max(np.abs(na['errors'] - nb['errors']) / nb['errors'])):.2e}"
                if found is None else "stepping on to the end"))
    if found is None:
        log(f"seed {seed}: no decision differs through iteration {min(ite, last)}")
    rec = {"seed": seed, "through": ite, "parting": found, "start_errors": start}  # iterations stepped
    if ref_series:
        series = a.best
        same = next((i for i, (x, y) in enumerate(zip(series, ref_series)) if x != y), len(series))
        rel = max(abs(x - y) / abs(y) for x, y in zip(series, ref_series))
        rec["card_series"] = {"iterations": len(series), "equal_through": same, "max_rel_to_bank": rel}
        log(f"seed {seed}: the card side's best errors equal its bank's through iteration {same} of "
            f"{len(series)} (max relative gap {rel:.2e})")
    if ite == sw.imax:
        from hybridquantization_tpu_torch.tools.parity_check import judge_target, quality

        target = judge_target(img)
        rec["final_deltaE"] = {n: quality(img, s.state.best_colors.cpu().numpy().astype(np.float64), target)[0]
                               for n, s in zip(SIDES, (a, b))}
    rec["seconds"] = round(time.time() - t0, 1)
    return jsonable(rec)


def report(seed: int, p: dict, log=print) -> None:
    """The parting as lines of text."""
    log(f"seed {seed} iteration {p['iteration']}: first differing decision(s) {p['decisions']}: {p['class']}")
    if p["class"] == "recompute":
        log(f"  {p['note']}")
        return
    for name in SIDES:
        s = p[name]
        log(f"  {name:5s} decisions {s['decisions']}; proposal errors {s['errors'].tolist()}; "
            f"current {s['current'].tolist()}; margins {s['margins']}")
    log(f"  errors read within {p['rel_gap']:.2e} relative; the card's state with the plain errors gives the "
        f"plain decision: {p['card_state_plain_errors_flips']}; the plain state with the card's errors gives "
        f"the card's: {p['plain_state_card_errors_flips']}; max |card proposal - plain proposal| "
        f"{p['max_proposal_gap']:.3e}")
    for key, view in p["oracle"].items():
        log(f"  f64 oracle {key}: proposals {view['proposals']}, current {view['current']}, best {view['best']}; "
            f"its decisions {view['decisions']}: with {view['with']}")


def append(path: str, rec: dict) -> None:
    """Append one JSON line to `path` in a single write (processes share the file)."""
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, (json.dumps(rec) + "\n").encode())
    finally:
        os.close(fd)


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", type=int, default=16)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--seeds", default="25,30,35,2,13")
    ap.add_argument("--until", type=int, default=0, help="the last iteration compared (default imax)")
    ap.add_argument("--to-end", action="store_true", help="step on to imax after the parting; final ΔE")
    ap.add_argument("--series", nargs="*", default=SERIES, help="the card bank's series files")
    ap.add_argument("--bank", default=os.path.join(C2, "draws_config1nat_fp32_jax.jsonl"))
    ap.add_argument("--cpu-bank", default=os.path.join(C2, "draws_config1nat_fp32_jax_cpu.jsonl"))
    ap.add_argument("--jobs", type=int, default=1, help="processes, the seeds dealt round-robin")
    ap.add_argument("--out", default=os.path.join(C2, "cardsteps_config1nat.jsonl"))
    ap.add_argument("--cpu", action="store_true", help="both sides on the CPU (a rehearsal)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("chip_steps: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.tools import smi_line
    from hybridquantization_tpu_torch.tools.engine_run import parse_seeds, run_jobs
    from hybridquantization_tpu_torch.tools.paired import load
    from hybridquantization_tpu_torch.tools.parity_check import content_image

    seeds = parse_seeds(args.seeds)
    if args.jobs > 1 and len(seeds) > 1:
        return run_jobs(os.path.abspath(__file__), argv, seeds, args.jobs)
    torch.set_num_threads(THREADS)
    devices = ("cpu", "cpu") if args.cpu else ("cuda", "cpu")
    card = "cpu" if args.cpu else smi_line()
    print(f"chip_steps: card side on {card}; plain side on the CPU, {THREADS} thread", flush=True)
    img = content_image(CONTENT, args.size)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=args.colors, population=4, imax=args.imax))
    config = {"content": CONTENT, "size": args.size, "colors": args.colors, "imax": args.imax}
    bank, cpu_bank = ({s: r for s, r in load(path).items() if all(r.get(k) == v for k, v in config.items())}
                      for path in (args.bank, args.cpu_bank))
    missing = [p for p in args.series if not os.path.exists(p)]
    if missing:
        print(f"chip_steps: no series file {missing}", file=sys.stderr)
        return 1
    series = {s: r for path in args.series for s, r in load(path).items()}
    for s in seeds:
        # a series holds to a seed of this configuration's bank, and only there
        ref = series[s]["best_error"] if s in bank and s in series else None
        if ref is None:
            print(f"seed {s}: no bank series of this configuration; the card side's best errors are not held",
                  flush=True)
        rec = step_pair(img, cfg, s, devices, args.until, args.to_end, ref_series=ref,
                        log=lambda line: print(line, flush=True))
        rec.update({"content": CONTENT, "size": args.size, "colors": args.colors, "imax": args.imax,
                    "device": card, "threads": THREADS})
        if "final_deltaE" in rec:
            rec["bank_deltaE"] = {"card": bank.get(s, {}).get("deltaE"), "plain": cpu_bank.get(s, {}).get("deltaE")}
            print(f"seed {s}: final ΔE card {rec['final_deltaE']['card']} (bank {rec['bank_deltaE']['card']}), "
                  f"plain {rec['final_deltaE']['plain']} (CPU bank {rec['bank_deltaE']['plain']})", flush=True)
        append(args.out, rec)
        print(f"seed {s}: {rec['seconds']} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
