"""JAX's fitness off the TPU against the port's emulation of it and the
port's fp32 fitness, palette by palette, on the CPU.

    python tests/jax_cpu_xla_scores.py --content natural --size 512 --colors 16 [--palettes 32] \
        [--precision f32x3|highest] > LOG

JAX's default branch off the TPU (`use_pallas="auto"`, the fitness of
`tests/jax_cpu_engine.py --branch xla`) assigns at the default precision
"f32x3" with its own hi/lo bf16 scores (`hybridquantization_tpu/ops/
assign.py:_scores`). For each of `--palettes` random palettes (numpy, seed
11, drawn as population-4 batches) this prints the pixels on which these
indices differ: JAX's XLA branch against `tools.tpu_f32x3.xla_f32x3_index`,
JAX's XLA branch and the port's fp32 index (`ops.assign.nearest_palette`)
each against the f64 oracle's (`tests/oracle.py`); and the relative
distance of JAX's fitness from the port's XLA-branch fitness
(`make_xla_population_fitness`), from the port's fp32 fitness
(`pipeline.make_population_fitness`) and from the oracle's. The last line
gives each column's median and maximum.

`--precision highest` holds JAX's branch at precision "highest" (a
`Precision.HIGHEST` dot, the fitness of `tests/jax_cpu_engine.py --branch
xla --precision highest`) to its counterpart in the port, the port's fp32
fitness and index: the "emu" columns then read the port's fp32 function,
so they repeat the fp32 ones. At either precision the column "non-tie
jax-oracle" counts the flips of JAX's index against the oracle's outside
the near-tie class: those on which the oracle's f64 distance to JAX's pick
exceeds its distance to its own pick by more than TIE_REL x max(1, |score|)
(score = 2 p.c - |c|^2 of the oracle's pick), the f32 summation floor of a
three-term score. A last line gives the maxima over the palettes on which
JAX's index equals the port's counterpart's everywhere.

Like the tests, this script imports jax and the port; it is not collected
by pytest. At config-1 natural, 32 palettes take about a minute on 8 CPU
cores.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hybridquantization_tpu import HybridQuantizer as JQuantizer  # noqa: E402
from hybridquantization_tpu import QuantizationConfig as JConfig  # noqa: E402
from hybridquantization_tpu import SWASAConfig as JSWASA  # noqa: E402
from hybridquantization_tpu.ops import assign as jassign  # noqa: E402
from hybridquantization_tpu.pipeline import _make_context as j_make_context  # noqa: E402
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness  # noqa: E402

COLUMNS = ("flips jax-emu", "flips jax-oracle", "non-tie jax-oracle", "flips fp32-oracle", "|jax-emu|", "|jax-fp32|",
           "|jax-oracle|")
#: a flip against the oracle is a near tie when the f64 distance gap is at most this x max(1, |score|)
TIE_REL = 1e-6


def beyond_ties(pixels64: np.ndarray, pal64: np.ndarray, idx: np.ndarray, ref: np.ndarray) -> int:
    """The pixels on which `idx` differs from `ref` (the oracle's index, or
    another engine's) by more than the near-tie class allows: their f64
    distances part by more than TIE_REL x max(1, |score of ref's pick|)."""
    flip = np.flatnonzero(idx != ref)
    p = pixels64[flip]
    d_got = ((p - pal64[idx[flip]]) ** 2).sum(-1)
    d_ref = ((p - pal64[ref[flip]]) ** 2).sum(-1)
    score = (p * p).sum(-1) - d_ref
    return int((np.abs(d_got - d_ref) > TIE_REL * np.maximum(1.0, np.abs(score))).sum())


def main(argv=None) -> int:
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.ops.assign import nearest_palette
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.tools.parity_check import content_image, judge_filters, load_oracle
    from hybridquantization_tpu_torch.tools.tpu_f32x3 import make_xla_population_fitness, xla_f32x3_index

    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="natural", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", type=int, default=16)
    ap.add_argument("--palettes", type=int, default=32, help="a multiple of the population, 4")
    ap.add_argument("--precision", default="f32x3", choices=["f32x3", "highest"],
                    help="JAX's precision field; highest: the emu columns read the port's fp32 function")
    args = ap.parse_args(argv)
    K, pop = args.colors, 4
    img = content_image(args.content, args.size)
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=pop), precision=args.precision)
    jq = JQuantizer(jcfg)
    jfit = jax.jit(j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg,
                                 jq.filters.half_width))
    jidx = jax.jit(lambda x, p: jassign.nearest_palette(x, p, precision=jcfg.precision))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=pop))
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    fp32 = make_population_fitness(ctx, cfg)
    if args.precision == "highest":
        emu, emu_index = fp32, nearest_palette
    else:
        emu, emu_index = make_xla_population_fitness(ctx, cfg), xla_f32x3_index
    oracle = load_oracle()
    ofilters, abs_k3 = judge_filters()
    img64 = img.astype(np.float64)
    target64 = oracle.srgb_to_scielab(img64, ofilters, abs_k3)
    pixels, pixels64 = img.reshape(-1, 3), img64.reshape(-1, 3)
    counterpart = "fp32 function" if args.precision == "highest" else "emulation of it"
    print(f"{args.content} {args.size}^2, K={K}: JAX's XLA branch (precision {jcfg.precision}) against the "
          f"port (emu: the port's {counterpart}); relative fitness distances", flush=True)
    print("palette  " + "  ".join(f"{c:>17}" for c in COLUMNS))
    rng = np.random.default_rng(11)
    rows = []
    for b, pals in enumerate(rng.random((args.palettes // pop, pop, K, 3), dtype=np.float32)):
        want = np.asarray(jfit(pals)[0], np.float64)
        got = emu(torch.from_numpy(pals))[0].numpy().astype(np.float64)
        plain = fp32(torch.from_numpy(pals))[0].numpy().astype(np.float64)
        for m, pal in enumerate(pals):
            j = np.asarray(jidx(pixels, pal))
            o = oracle.nearest_palette(pixels64, pal.astype(np.float64))
            e = emu_index(ctx["assign_pixels"], torch.from_numpy(pal)).numpy()
            f = nearest_palette(ctx["assign_pixels"], torch.from_numpy(pal)).numpy()
            of = oracle.fitness(img64, target64, pal.astype(np.float64), ofilters, abs_k3)
            w = want[m]
            row = (int((j != e).sum()), int((j != o).sum()), beyond_ties(pixels64, pal.astype(np.float64), j, o),
                   int((f != o).sum()),
                   abs(w - got[m]) / w, abs(w - plain[m]) / w, abs(w - of) / of)
            rows.append(row)
            print(f"{b * pop + m:>7}  " + "  ".join(f"{v:>17}" if isinstance(v, int) else f"{v:>17.3e}"
                                                    for v in row), flush=True)
    r = np.array(rows, np.float64)
    print("median   " + "  ".join(f"{v:>17.3g}" for v in np.median(r, axis=0)))
    print("max      " + "  ".join(f"{v:>17.3g}" for v in np.max(r, axis=0)))
    same = r[:, 0] == 0
    if same.any():  # one flipped pixel moves the mean S-CIELAB error by up to ~1e-5 on smooth content
        print("max same " + "  ".join(f"{v:>17.3g}" for v in np.max(r[same], axis=0))
              + f"   (the {int(same.sum())} palettes with no index flip jax-emu)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
