"""Layer 2 (`fitness_parity`'s protocol) with the JAX engine's own f32x3
fitness, evaluated on the CPU.

    python tests/jax_cpu_layer2.py [--branch f32x3|xla|highest] --content smooth --size 512 --colors 16 > LOG

The fitness (`--branch f32x3`, the default) is the Pallas branch of
`hybridquantization_tpu.pipeline.make_population_fitness` at
precision="f32x3" in interpret mode: its assignment kernel and its fused
S-CIELAB kernel split their operands into bf16 hi/lo themselves, so this is
the TPU kernels' function computed with XLA's f32 arithmetic on the CPU, in
XLA's orders of accumulation. The flips are JAX's f32x3 `assign_idx` of
member 0 against the oracle's. The log has `fitness_parity`'s lines (the
flags are its own), so `chip_c2.py`'s fingerprint sets its per-palette gaps
beside the TPU's (`docs/evidence/`) and the port's as the column "jax_cpu"
when `docs/evidence_h100/c2/fitness_parity_jaxcpu_<config>.log` exists:
how far the TPU's own arithmetic sits from its function off the TPU.
`--branch xla` evaluates instead the fitness `tests/jax_cpu_engine.py
--branch xla` anneals with: the default `use_pallas="auto"`, off the TPU
JAX's function in XLA (`jax.jit` of `make_population_fitness`): f32, but
its assignment at the default "f32x3" scores with three bf16 hi/lo dots
(`hybridquantization_tpu/ops/assign.py:_scores`); its
flips are JAX's `ops.assign.nearest_palette` of member 0 against the
oracle's. `--branch highest` is that branch at `precision="highest"` (the
fitness of `tests/jax_cpu_engine.py --branch xla --precision highest`): a
`Precision.HIGHEST` dot in the assignment, so JAX's f32 function, the one
the port's fp32 engine computes.

Like the tests, this script imports jax and the port; it is not collected
by pytest (a config-2 run takes minutes).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hybridquantization_tpu import HybridQuantizer as JQuantizer  # noqa: E402
from hybridquantization_tpu import QuantizationConfig as JConfig  # noqa: E402
from hybridquantization_tpu import SWASAConfig as JSWASA  # noqa: E402
from hybridquantization_tpu import colorspace as jcs  # noqa: E402
from hybridquantization_tpu.ops import assign as assign_ops  # noqa: E402
from hybridquantization_tpu.ops import pallas_assign as pa  # noqa: E402
from hybridquantization_tpu.pipeline import _make_context as j_make_context  # noqa: E402
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness  # noqa: E402


def jax_fitness(img: np.ndarray, cfg, device):
    """`fitness_parity`'s evaluator: numpy (pop, K, 3) palettes -> (numpy
    (pop,) JAX f32x3 errors, (P,) int32 JAX f32x3 index of member 0)."""
    sw = cfg.swasa
    jcfg = JConfig(swasa=JSWASA(num_colors=sw.num_colors, population=sw.population), use_pallas="on",
                   precision="f32x3")
    jq = JQuantizer(jcfg)
    fit = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg, jq.filters.half_width)
    P = img.shape[0] * img.shape[1]
    block = pa.pick_block(sw.num_colors)
    x4 = pa.pack_pixels(jnp.asarray(img.reshape(-1, 3)), block)

    def evaluate(pals: np.ndarray):
        errors, _ = fit(jnp.asarray(pals))
        p = jnp.asarray(pals[0])
        c4, _ = pa.pack_palette(p, jcs.srgb_to_opp(p))
        idx = pa.assign_idx(x4, c4, block=block, interpret=True, precision="f32x3")
        return np.asarray(errors), np.asarray(idx)[0, :P]

    return evaluate


def xla_fitness(img: np.ndarray, cfg, device, precision: str = "f32x3"):
    """`fitness_parity`'s evaluator for JAX's default branch off the TPU at
    `precision`: (numpy (pop,) JAX f32 errors, (P,) int32 JAX index of
    member 0)."""
    sw = cfg.swasa
    jcfg = JConfig(swasa=JSWASA(num_colors=sw.num_colors, population=sw.population), precision=precision)
    jq = JQuantizer(jcfg)
    fit = jax.jit(j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg, jq.filters.half_width))
    nearest = jax.jit(lambda x, p: assign_ops.nearest_palette(x, p, precision=jcfg.precision))
    pixels = jnp.asarray(img.reshape(-1, 3))

    def evaluate(pals: np.ndarray):
        errors, _ = fit(jnp.asarray(pals))
        return np.asarray(errors), np.asarray(nearest(pixels, jnp.asarray(pals[0])), np.int32)

    return evaluate


#: --branch -> (the log's first line, the evaluator)
BRANCHES = {
    "f32x3": ("the JAX engine's f32x3 Pallas branch in interpret mode on the CPU", jax_fitness),
    "xla": ("the JAX engine's default branch off the TPU (f32, XLA) on the CPU", xla_fitness),
    "highest": ("the JAX engine's default branch off the TPU at precision highest (f32, XLA) on the CPU",
                functools.partial(xla_fitness, precision="highest")),
}


def main(argv=None) -> int:
    from hybridquantization_tpu_torch.tools import fitness_parity

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--branch", default="f32x3", choices=list(BRANCHES))
    args, rest = ap.parse_known_args(argv)
    title, evaluator = BRANCHES[args.branch]
    if args.branch == "highest" and "--precision" not in rest:
        rest += ["--precision", "highest"]  # so the log's summary line names it
    print(f"fitness: {title}", flush=True)
    return fitness_parity.main(rest, device="cpu", evaluator=evaluator)


if __name__ == "__main__":
    raise SystemExit(main())
