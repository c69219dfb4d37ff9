"""Layer 2 (`fitness_parity`'s protocol) with the JAX engine's own f32x3
fitness, evaluated on the CPU.

    python tests/jax_cpu_layer2.py --content smooth --size 512 --colors 16 > LOG

The fitness is the Pallas branch of
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

Like the tests, this script imports jax and the port; it is not collected
by pytest (a config-2 run takes minutes).
"""

from __future__ import annotations

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


def main(argv=None) -> int:
    from hybridquantization_tpu_torch.tools import fitness_parity

    print("fitness: the JAX engine's f32x3 Pallas branch in interpret mode on the CPU", flush=True)
    return fitness_parity.main(argv, device="cpu", evaluator=jax_fitness)


if __name__ == "__main__":
    raise SystemExit(main())
