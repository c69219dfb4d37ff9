#!/usr/bin/env python3
"""Does the draw stream or the score arithmetic move the port's final ΔE?

    python3 chip_draws.py [--content natural --size 512 --colors 16 --seeds 0-95
                           --draws device|host|jax --fitness fp32|split|f32x3|xla
                           --space srgb|lab --precision P --conv-precision P
                           --counts PATH --series PATH --out PATH --cpu]

The diagnostic of ROADMAP fault C2 (the port's mean ΔE above the JAX TPU
engine's at config-1 natural and config-2), and the paired layer 3 of
`chip_parity.py`. It runs `engine_run`'s anneal (imax 1500, population 4;
the fitness on the card; by default f32x3 and sRGB, else the
`QuantizationConfig` of --space, --precision and --conv-precision, as
`engine_run`'s --assignment-space, --precision and --conv-precision) with:

  --draws device      the draws of `find_palette` with a generator on the
                      card seeded with the seed (Philox): the same run as
                      `engine_run`'s, seed for seed;
          host        every draw from a CPU generator (mt19937) seeded with
                      the seed, in `schedule.draw_step`'s order, copied to
                      the card each iteration;
          jax         the JAX engine's own stream for `PRNGKey(seed)`
                      (`tools.jax_draws.engine_draws`, threefry2x32 as JAX
                      0.9.0 draws it), copied to the card each iteration; a
                      bank of it pairs seed by seed with the JAX TPU
                      engine's bank;
  --fitness fp32      the engine's fitness (B1, then B2, each at the
                      configuration's precision: fp32 for "highest" and
                      "f32x3", or bf16);
            split     the TPU's f32x3 assignment (`tools.tpu_f32x3`:
                      split_assign, then B2 in fp32);
            f32x3     the whole TPU fitness emulated: split_assign, then
                      B2 in its split mode, the TPU kernel's f32x3 conv;
            xla       the fitness JAX runs off the TPU at f32x3
                      (`tools.tpu_f32x3.make_xla_population_fitness`: the
                      XLA branch's hi/lo bf16 scores with the bias in f32,
                      then B2 in fp32), the function of
                      `tests/jax_cpu_engine.py --branch xla` (split, f32x3
                      and xla take only the default sRGB, f32x3
                      configuration);
  --counts PATH       appends, per seed, each iteration's acceptances
                      (members whose current error took the proposal),
                      uphill acceptances among them, convergence overwrites
                      (members that lost the keep-draw) and best
                      improvements, computed here from the step's tensors
                      and draws; `loop.run_chunk` is not changed;
  --series PATH       appends, per seed, each iteration's best error
                      (`state.best_error`), the counterpart of
                      `tests/jax_cpu_engine.py --series`.

The records are `engine_run`'s (its "precision" and "assignment_space"
among them) with "draws", "assign" (the scores' arithmetic: fp32, bf16,
split or xla) and "conv" (B2's: fp32, bf16 or split) fields, judged by the same
f64 oracle (in CIELAB for --space lab), so the frozen
`tools/parity_report.py` sets them against any bank of the same
configuration. Seeds already in the file are skipped. Exits non-zero
without a CUDA device unless --cpu asks for the CPU (the kernels' plain
versions).

Imports torch, numpy, scipy (the oracle), the standard library and the
port; never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hybridquantization_tpu_torch.config import PRECISIONS

REPO = os.path.dirname(os.path.abspath(__file__))
DRAWS = ("device", "host", "jax")
#: --fitness -> (assignment, B2's arithmetic), the records' "assign" and "conv"
#: (the engine's fitness, "fp32", runs a bf16 precision as bf16: `arithmetic`)
FITNESS = {"fp32": ("fp32", "fp32"), "split": ("split", "fp32"), "f32x3": ("split", "split"),
           "xla": ("xla", "fp32")}
#: the series --counts records per iteration
COUNTS = ("accepted", "uphill", "overwritten", "improved")


def _fitness(ctx, cfg, fitness: str):
    from hybridquantization_tpu_torch.pipeline import make_population_fitness
    from hybridquantization_tpu_torch.tools.tpu_f32x3 import (make_split_population_fitness,
                                                              make_xla_population_fitness)

    assign, conv = FITNESS[fitness]
    if assign == "split":
        return make_split_population_fitness(ctx, cfg, conv)
    if assign == "xla":
        return make_xla_population_fitness(ctx, cfg)
    return make_population_fitness(ctx, cfg)


def arithmetic(fitness: str, cfg) -> tuple[str, str]:
    """The records' ("assign", "conv") of `fitness` under `cfg`."""
    if fitness != "fp32":
        return FITNESS[fitness]
    conv = cfg.conv_precision or cfg.precision
    return tuple("bf16" if p == "bf16" else "fp32" for p in (cfg.precision, conv))


def _draw_source(draws: str, seed: int, pop: int, K: int, dev):
    """(start palettes on `dev` or None for the card generator's own, the
    generator init_state takes, draws() -> the next iteration's draws on `dev`)."""
    from hybridquantization_tpu_torch.swasa import schedule
    from hybridquantization_tpu_torch.tools import jax_draws

    if draws == "device":
        g = torch.Generator(device=dev).manual_seed(seed)
        return None, g, lambda: schedule.draw_step(g, pop, K)
    if draws == "host":
        g = torch.Generator().manual_seed(seed)
        init = schedule.random_palettes(g, pop, K).to(dev)
        return init, torch.Generator(device=dev), lambda: {
            k: v.to(dev) for k, v in schedule.draw_step(g, pop, K).items()}
    stream = jax_draws.engine_draws(seed, pop, K)
    init = torch.from_numpy(next(stream)).to(dev)
    return init, torch.Generator(device=dev), lambda: {
        k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}


def anneal(img, cfg, seed: int, dev, draws: str = "device", fitness: str = "fp32",
           counts: bool = False, series: bool = False):
    """find_palette's random-init anneal with the chosen draws and fitness:
    (best palette (K, 3) float64, {count: (imax,) int} or None, each
    iteration's best error as an (imax,) float list or None)."""
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import loop, schedule

    sw = cfg.swasa
    fit = _fitness(_make_context(img, build_filters(), cfg, dev), cfg, fitness)
    seen = {}

    def fitness(p):
        seen["errors"], usage = fit(p)
        return seen["errors"], usage

    init, gen, source = _draw_source(draws, seed, sw.population, sw.num_colors, dev)
    state = loop.init_state(gen, fitness, sw, init)
    step = loop.make_step(fitness, sw)
    rows = torch.zeros((sw.imax, len(COUNTS)), dtype=torch.int32, device=dev) if counts else None
    best = torch.zeros(sw.imax, dtype=torch.float32, device=dev) if series else None
    for i in range(sw.imax):
        d = source()
        ite = torch.tensor(i + 1, dtype=torch.int32, device=dev)
        new, _ = step(state, ite, d)
        if counts:
            gap = seen["errors"] - state.current_errors
            accepted = schedule.accept(gap, new.temperature[..., None], d["acc"])
            lost = ~schedule.keeps_values(ite, sw.conv_delay, sw.conv_spread, sw.imax, d["conv"])
            if not (sw.convergence and sw.population > 1):
                lost = torch.zeros_like(lost)
            rows[i] = torch.stack([accepted.sum(), (accepted & (gap > 0)).sum(), lost.sum(),
                                   (new.best_error < state.best_error).sum()]).to(torch.int32)
        if series:
            best[i] = new.best_error
        state = new
    palette = state.best_colors.cpu().numpy().astype(np.float64)
    counted = None
    if counts:
        rows = rows.cpu().numpy()
        counted = {k: rows[:, j].tolist() for j, k in enumerate(COUNTS)}
    return palette, counted, best.cpu().tolist() if series else None


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="natural", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", type=int, default=16)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--seeds", default="0-95")
    ap.add_argument("--draws", default="host", choices=DRAWS)
    ap.add_argument("--fitness", default="fp32", choices=list(FITNESS))
    ap.add_argument("--space", default="srgb", choices=["srgb", "lab"], help="the assignment space")
    ap.add_argument("--precision", default="f32x3", choices=PRECISIONS)
    ap.add_argument("--conv-precision", default="", choices=("",) + PRECISIONS)
    ap.add_argument("--counts", default="", help="append per-iteration counts per seed here")
    ap.add_argument("--series", default="", help="append each seed's per-iteration best error here")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "evidence_h100", "c2",
                                                  "draws_config1nat_host.jsonl"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.fitness != "fp32" and (args.space, args.precision, args.conv_precision) != ("srgb", "f32x3", ""):
        ap.error(f"--fitness {args.fitness} emulates the default sRGB, f32x3 configuration only")
    return args


def main(argv=None, *, device="cuda") -> int:
    args = parse_args(argv)
    device = "cpu" if args.cpu else device
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_draws: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.tools import smi_line
    from hybridquantization_tpu_torch.tools.engine_run import done_seeds, parse_seeds
    from hybridquantization_tpu_torch.tools.parity_check import content_image, judge_target, quality

    dev = setup_device(device)
    done = done_seeds(args.out)
    todo = [s for s in parse_seeds(args.seeds) if s not in done]
    print(f"seeds todo {todo} (already done: {sorted(done)})", flush=True)
    img = content_image(args.content, args.size)
    target64 = judge_target(img)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=args.colors, population=4, imax=args.imax),
                             precision=args.precision, conv_precision=args.conv_precision,
                             assignment_space=args.space)
    device_name = smi_line() if dev.type == "cuda" else "cpu"
    assign, conv = arithmetic(args.fitness, cfg)
    for i, s in enumerate(todo):
        t0 = time.time()
        palette, counted, best = anneal(img, cfg, s, dev, args.draws, args.fitness, bool(args.counts),
                                        bool(args.series))
        t_anneal = time.time() - t0
        de, mse = quality(img, palette, target64, args.space)
        rec = {"seed": s, "deltaE": de, "mse": mse, "precision": args.precision, "size": args.size,
               "colors": args.colors, "imax": args.imax, "population": 4, "content": args.content,
               "assignment_space": args.space, "anneal_seconds": round(t_anneal, 3), "engine": "torch",
               "device": device_name, "draws": args.draws, "assign": assign, "conv": conv}
        if i == 0:
            rec["compile_inclusive"] = True
        if counted is not None:
            with open(args.counts, "a") as f:
                f.write(json.dumps({"seed": s, "draws": args.draws, "assign": assign,
                                    "deltaE": de, **counted}) + "\n")
        if best is not None:
            with open(args.series, "a") as f:
                f.write(json.dumps({"seed": s, "engine": "torch", "draws": args.draws, "assign": assign,
                                    "conv": conv, "deltaE": de, "best_error": best}) + "\n")
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        print(f"[{args.draws} draws, {args.fitness} fitness] {rec}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
