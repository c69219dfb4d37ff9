#!/usr/bin/env python3
"""Does the source of the anneal's uniform draws move the port's final ΔE?

    python3 chip_draws.py [--content natural --size 512 --colors 16 --seeds 0-95
                           --out docs/evidence_h100/c2/draws_config1nat_host.jsonl]

The diagnostic of ROADMAP fault C2 (the port's mean ΔE above the JAX
engine's and the oracle's at config-1 natural). It runs `engine_run`'s
anneal (imax 1500, population 4, f32x3, sRGB; B1 and B2 on the card) with
every uniform draw taken instead from a CPU generator (mt19937) seeded with
the seed, in `schedule.draw_step`'s order, and copied to the card each
iteration; `find_palette` draws from a generator on the card (Philox). The
records are `engine_run`'s, with "draws": "host", and are judged by the same
f64 oracle, so the frozen `tools/parity_report.py` sets them against
`engine_run`'s bank of the same configuration. Seeds already in the file
are skipped. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def anneal_host_draws(img, cfg, seed: int, dev) -> np.ndarray:
    """find_palette's random-init anneal, its draws from a CPU generator."""
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import loop, schedule

    fit = make_population_fitness(_make_context(img, build_filters(), cfg, dev), cfg)
    g = torch.Generator().manual_seed(seed)
    pop, K = cfg.swasa.population, cfg.swasa.num_colors
    init = schedule.random_palettes(g, pop, K).to(dev)
    state = loop.init_state(torch.Generator(device=dev), fit, cfg.swasa, init)
    step = loop.make_step(fit, cfg.swasa)
    for ite in range(1, cfg.swasa.imax + 1):
        draws = {k: v.to(dev) for k, v in schedule.draw_step(g, pop, K).items()}
        state, _ = step(state, torch.tensor(ite, dtype=torch.int32, device=dev), draws)
    return state.best_colors.cpu().numpy().astype(np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="natural", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", type=int, default=16)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--seeds", default="0-95")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                                                  "evidence_h100", "c2", "draws_config1nat_host.jsonl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_draws: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.tools import smi_line
    from hybridquantization_tpu_torch.tools.engine_run import done_seeds, parse_seeds
    from hybridquantization_tpu_torch.tools.parity_check import content_image, judge_target, quality

    dev = setup_device("cuda")
    done = done_seeds(args.out)
    todo = [s for s in parse_seeds(args.seeds) if s not in done]
    print(f"seeds todo {todo} (already done: {sorted(done)})", flush=True)
    img = content_image(args.content, args.size)
    target64 = judge_target(img)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=args.colors, population=4, imax=args.imax))
    device_name = smi_line()
    for i, s in enumerate(todo):
        t0 = time.time()
        palette = anneal_host_draws(img, cfg, s, dev)
        t_anneal = time.time() - t0
        de, mse = quality(img, palette, target64)
        rec = {"seed": s, "deltaE": de, "mse": mse, "precision": "f32x3", "size": args.size,
               "colors": args.colors, "imax": args.imax, "population": 4, "content": args.content,
               "assignment_space": "srgb", "anneal_seconds": round(t_anneal, 3), "engine": "torch",
               "device": device_name, "draws": "host"}
        if i == 0:
            rec["compile_inclusive"] = True
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[host draws] {rec}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
