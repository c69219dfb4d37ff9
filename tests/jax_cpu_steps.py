"""JAX's anneal and the port's, stepped side by side on the CPU, to the first
decision that differs.

    python tests/jax_cpu_steps.py --content natural --size 512 --colors 16 --seed 0 \\
        [--imax 1500] [--until 1500] [--series JAX_SERIES.jsonl] [--precision f32x3|highest]

Both engines start from the same palettes and take the same draws: JAX's
`find_palette` stream for `PRNGKey(seed)` (JAX from `jax.random`, the port
from `tools.jax_draws`, checked equal every iteration). JAX steps with its
own `swasa.loop.make_step` over its default fitness off the TPU (f32 in
XLA, the `tests/jax_cpu_engine.py --branch xla` anneal; `--precision
highest` for its `--precision highest` anneal), the port with its
`swasa.loop.make_step` over its fitness on the CPU (the kernels' plain
versions). Each follows its own decisions. Every iteration the decisions
of `make_step` are recomputed from the proposals' errors and the draws:
acceptance per member, the convergence keep per member, the convergence
source (the proposal with the least error, where a member is overwritten)
and the best update. At the first iteration where a decision differs, the
script prints both sides' errors, the margin of each decision, the f64
oracle's fitness (`tests/oracle.py`) of the proposals involved, and stops.
With `--series` (a `jax_cpu_engine.py --series` file) it also reports how
far JAX's stepped best errors sit from that run's (one jitted step at a
time is not the run's scan: XLA may round a step's sums otherwise).

Like the tests, this script imports jax and the port; it is not collected
by pytest. At config-1 natural it steps about 1.5 iterations a second on 8
CPU cores.
"""

from __future__ import annotations

import argparse
import json
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
from hybridquantization_tpu.pipeline import _make_context as j_make_context  # noqa: E402
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness  # noqa: E402
from hybridquantization_tpu.swasa import loop as jloop  # noqa: E402
from hybridquantization_tpu.swasa import schedule as jschedule  # noqa: E402


def decisions(errors, current, temperature, u_acc, u_conv, ite, best, sw):
    """`make_step`'s decisions from one iteration's numbers (numpy, f32):
    {"accept": (pop,) bool, "keep": (pop,) bool, "source": the convergence
    source or None when no member is overwritten, "best": the improving
    member or None}, and the margins they were taken by."""
    gap = errors - current
    with np.errstate(over="ignore", divide="ignore"):
        boltz = np.exp(-gap / temperature)
    accept = (gap <= 0) | (boltz > u_acc)
    keep_p = np.float32(np.asarray(jschedule.keep_probability(ite, sw.conv_delay, sw.conv_spread, sw.imax)))
    keep = keep_p > u_conv if sw.convergence and len(errors) > 1 else np.ones(len(errors), bool)
    cand = np.where(accept, errors, np.inf)
    m = int(np.argmin(cand))
    order = np.sort(errors)
    return ({"accept": accept, "keep": keep, "source": None if keep.all() else int(np.argmin(errors)),
             "best": m if cand[m] < best else None},
            {"boltzmann - u": boltz - u_acc, "keep p - u": keep_p - u_conv,
             "least two errors": order[:2].tolist()})


def main(argv=None) -> int:
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import loop
    from hybridquantization_tpu_torch.tools import jax_draws
    from hybridquantization_tpu_torch.tools.parity_check import content_image, judge_filters, load_oracle

    ap = argparse.ArgumentParser()
    ap.add_argument("--content", default="natural", choices=["smooth", "natural"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--colors", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--until", type=int, default=0, help="the last iteration to step (default imax)")
    ap.add_argument("--series", default="", help="jax_cpu_engine.py --series file to hold JAX's steps to")
    ap.add_argument("--precision", default="f32x3", choices=["f32x3", "highest"],
                    help="JAX's precision field (highest: its f32 function, the port's)")
    args = ap.parse_args(argv)
    K, pop = args.colors, 4
    img = content_image(args.content, args.size)
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=pop, imax=args.imax), precision=args.precision)
    sw = jcfg.swasa
    jq = JQuantizer(jcfg)
    jfit = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg, jq.filters.half_width)
    jfit_jit = jax.jit(jfit)
    jstep = jax.jit(jloop.make_step(jfit, sw))
    jprop = jax.jit(lambda k, c, i: jschedule.propose(k, c, i, sw.s0, sw.beta, sw.imax))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=pop, imax=args.imax))
    pfit = make_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)
    seen = {}

    def pfitness(p):
        seen["errors"], usage = pfit(p)
        return seen["errors"], usage

    pstep = loop.make_step(pfitness, cfg.swasa)
    ref = {}
    if args.series:
        with open(args.series) as f:
            ref = {r["seed"]: r["best_error"] for r in map(json.loads, f)}.get(args.seed, [])

    jstate = jloop.init_state(jax.random.PRNGKey(args.seed), jfit, sw)
    stream = jax_draws.engine_draws(args.seed, pop, K)
    pstate = loop.init_state(torch.Generator(), pfitness, cfg.swasa, torch.from_numpy(next(stream).copy()))
    if not np.array_equal(np.asarray(jstate.colors), pstate.colors.numpy()):
        raise SystemExit("the start palettes differ")
    print(f"seed {args.seed}: start palettes equal; errors JAX {np.asarray(jstate.current_errors)} "
          f"port {pstate.current_errors.numpy()}", flush=True)
    drift = 0.0  # the largest relative distance of JAX's stepped best errors from its run's
    for ite in range(1, (args.until or args.imax) + 1):
        d = {k: torch.from_numpy(v.copy()) for k, v in next(stream).items()}
        _, k_prop, k_acc, k_conv = jax.random.split(jstate.key, 4)
        u_acc = np.asarray(jax.random.uniform(k_acc, (pop,)))
        u_conv = np.asarray(jax.random.uniform(k_conv, (pop,)))
        if not (np.array_equal(u_acc, d["acc"].numpy()) and np.array_equal(u_conv, d["conv"].numpy())):
            raise SystemExit(f"iteration {ite}: the draws differ")
        it = jnp.int32(ite)
        jprops = jprop(k_prop, jstate.colors, it)
        je = np.asarray(jfit_jit(jprops)[0])
        jT = np.float32(np.asarray(jschedule.cool_temperature(jstate.temperature, it, sw.i_tc, sw.alpha)))
        jd, jm = decisions(je, np.asarray(jstate.current_errors), jT, u_acc, u_conv, it,
                           float(jstate.best_error), sw)
        pnew, _ = pstep(pstate, torch.tensor(ite, dtype=torch.int32), d)
        pe = seen["errors"].numpy()
        pd, pm = decisions(pe, pstate.current_errors.numpy(), np.float32(pnew.temperature.item()), u_acc,
                           u_conv, it, float(pstate.best_error), sw)
        jnew, _ = jstep(jstate, it)
        if ref:
            drift = max(drift, abs(float(jnew.best_error) - ref[ite - 1]) / ref[ite - 1])
        differ = [k for k in jd if not np.array_equal(jd[k], pd[k])]
        if differ:
            oracle = load_oracle()
            ofilters, abs_k3 = judge_filters()
            img64 = img.astype(np.float64)
            target = oracle.srgb_to_scielab(img64, ofilters, abs_k3)
            props = np.asarray(jprops, np.float64)
            o = [oracle.fitness(img64, target, props[i], ofilters, abs_k3) for i in range(pop)]
            print(f"iteration {ite}: first differing decision(s) {differ}")
            for name, dec, err, margin in (("JAX", jd, je, jm), ("port", pd, pe, pm)):
                print(f"  {name:4s} decisions {dec}; proposal errors {err.tolist()}; margins {margin}")
            print(f"  f64 oracle fitness of JAX's proposals {o} (least: member {int(np.argmin(o))})")
            print(f"  relative error against it: JAX {((je - o) / o).tolist()}, port {((pe - o) / o).tolist()}")
            gap = np.abs(np.asarray(jprops) - port_proposals(pstate, ite, d, sw)).max()
            print(f"  max |JAX proposal - port proposal| {float(gap):.3e}")
            if ref:
                print(f"  JAX stepped here, its best errors so far within {drift:.2e} relative of its run's")
            return 0
        if ite % 100 == 0:
            print(f"iteration {ite}: decisions equal so far; max relative error difference "
                  f"{float(np.max(np.abs(je - pe) / je)):.2e}"
                  + (f"; JAX stepped within {drift:.2e} of its run" if ref else ""), flush=True)
        jstate, pstate = jnew, pnew
    print(f"no decision differs through iteration {ite}")
    return 0


def port_proposals(pstate, ite, d, sw):
    """The port's proposals of this iteration (its `schedule.propose`)."""
    from hybridquantization_tpu_torch.swasa import schedule

    it = torch.tensor(ite, dtype=torch.int32)
    return schedule.propose(pstate.colors, it, sw.s0, sw.beta, sw.imax, d["prop"]).numpy()


if __name__ == "__main__":
    raise SystemExit(main())
