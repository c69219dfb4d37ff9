"""Deterministic engine-against-oracle fitness parity (layer 2 of docs/PARITY.md).

The counterpart of `tools/fitness_parity.py`, with the same flags and
output lines, and a first line with the card's name and power limit. For
IDENTICAL palettes it evaluates the port's population fitness, the function
the SWASA loop optimises (`make_population_fitness` on `_make_context`: B1,
then B2, on the card), against the f64 oracle's definitional fitness
(`tests/oracle.py`), and reports the relative gap and the share of pixels
whose assignment differs. No anneal, so no seed noise: every digit of the
gap is numerics. The assignment compared is B1's own index for member 0,
the one its fitness used.

Batch 0 is a near-tie stress (informational, not gated): a duplicate entry
and an entry perturbed by 1e-7 relative. The engine, like the reference's
all-`float` OpenCL path, collapses the perturbation to an exact tie (first
index wins) where the f64 oracle resolves it.

Usage:
  python -m hybridquantization_tpu_torch.tools.fitness_parity [--size 1024]
      [--colors 64] [--palettes 12] [--population 4] [--precision f32x3]
      [--conv-precision ""] [--tolerance 1e-3] [--content smooth] [--cpu]

Exits 1 on FAIL.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .parity_check import content_image, judge_filters, judge_target, load_oracle

#: the seed of the palette draws (the JAX tool's)
PALETTE_SEED = 7


def palette_batch(rng, b: int, population: int, colors: int) -> np.ndarray:
    """(pop, K, 3) float32 palettes of batch b; batch 0 gets the near ties."""
    pals = rng.random((population, colors, 3)).astype(np.float32)
    if b == 0:
        pals[0, 1] = pals[0, 0]
        pals[1, 1] = pals[1, 0] * (1 + 1e-7)
    return pals


def engine_fitness(img: np.ndarray, cfg, device):
    """The port's population fitness of `img`: numpy (pop, K, 3) palettes ->
    (numpy (pop,) errors, (P,) int32 B1 index of member 0)."""
    import torch

    from .. import colorspace as cs
    from ..ops.assign_kernel import assign_opp_usage_pop
    from ..pipeline import _features, _make_context, make_population_fitness
    from ..scielab.filters import build_filters

    ctx = _make_context(img, build_filters(cfg.scielab.dpi, cfg.scielab.viewing_distance_cm),
                        cfg, device)
    fit = make_population_fitness(ctx, cfg)

    def evaluate(pals: np.ndarray):
        p = torch.as_tensor(pals, device=device)
        errors, _ = fit(p)
        _, _, idx = assign_opp_usage_pop(
            ctx["assign_pixels"], _features(p[:1], cfg, ctx["whitepoint"]), cs.srgb_to_opp(p[:1]),
            precision=cfg.precision, tie_mode=cfg.tie_mode, return_index=True,
        )
        return errors.cpu().numpy(), idx[0].cpu().numpy()

    return evaluate


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="smooth", choices=["smooth", "natural"],
                    help="content class (natural = 1/f value noise); this layer is "
                    "deterministic, so it reaches config-2-natural scale without the anneal's noise")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--colors", "-k", type=int, default=64)
    ap.add_argument("--palettes", type=int, default=12, help="number of palette batches to evaluate")
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--precision", default="f32x3", choices=["highest", "f32x3", "bf16"])
    ap.add_argument("--conv-precision", default="", choices=["", "highest", "f32x3", "bf16"])
    ap.add_argument("--tolerance", type=float, default=1e-3,
                    help="max relative fitness gap for PASS (0.1%%, 10x tighter than the 1%% "
                    "quality budget)")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    return ap.parse_args(argv)


def main(argv=None, *, device="cuda", evaluator=None) -> int:
    """Layer 2 with `evaluator(img, cfg, device)` (default `engine_fitness`)."""
    args = parse_args(argv)
    from .. import QuantizationConfig, SWASAConfig
    from ..pipeline import setup_device
    from . import device_line

    dev = setup_device("cpu" if args.cpu else device)
    print(device_line(dev), flush=True)
    oracle = load_oracle()
    img = content_image(args.content, args.size)
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=args.colors, population=args.population),
        precision=args.precision, conv_precision=args.conv_precision,
    )
    evaluate = (evaluator or engine_fitness)(img, cfg, dev)
    ofilters, abs_k3 = judge_filters()
    target = judge_target(img)
    img64 = img.astype(np.float64)

    rng = np.random.default_rng(PALETTE_SEED)
    gaps, tie_gaps, flips = [], [], []
    npix = args.size * args.size
    for b in range(args.palettes):
        pals = palette_batch(rng, b, args.population, args.colors)
        t0 = time.time()
        errs, eng_idx = evaluate(pals)
        dt_eng = time.time() - t0
        o_errs = np.array([
            oracle.fitness(img64, target, p.astype(np.float64), ofilters, abs_k3) for p in pals
        ])
        gap = np.abs(errs - o_errs) / o_errs
        (tie_gaps if b == 0 else gaps).extend(gap.tolist())
        o_idx = oracle.nearest_palette(img64.reshape(-1, 3), pals[0].astype(np.float64))
        flips.append(float((eng_idx != o_idx).mean()))
        print(f"batch {b}: rel fitness gap " + " ".join(f"{g:.2e}" for g in gap)
              + f"  assign flips {flips[-1]:.2e}  (engine {dt_eng:.2f}s)", flush=True)

    gaps = np.asarray(gaps)
    print(f"\nfitness gap over {len(gaps)} random-palette evals: "
          f"max {gaps.max():.3e} mean {gaps.mean():.3e}  (precision={args.precision}, "
          f"conv={args.conv_precision or args.precision}, f64 oracle)")
    if tie_gaps:
        print(f"tie-stress batch (informational): max gap {max(tie_gaps):.3e} — sub-f32 "
              "perturbations resolved by the f64 oracle but not by the engine or the "
              "reference's float OpenCL path")
    print(f"assignment flips: max {max(flips):.3e} of {npix} px "
          "(near-tie f32-rounding class, docs/PERFORMANCE.md)")
    ok = gaps.max() <= args.tolerance
    print("DETERMINISTIC PARITY:", "PASS" if ok else "FAIL",
          f"(tolerance {args.tolerance:.0e}, random palettes)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
