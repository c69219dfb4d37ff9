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
oracle's fitness (`tests/oracle.py`) of the proposals involved, the
parting's class (`tools.steps.classify`: "arithmetic" or "logic") and the
side the oracle's recomputed decisions take, each side's best error so far
(the iteration it was set, and the best palette judged again in every
member's slot), and, where the two sides count a palette entry as used
differently (an unused entry costs `delta`), the pixels the port's
assignment sends there with their f64 distances to it and to the nearest
other entry; then it stops. The decisions are
`tools.steps.decisions` with JAX's keep probability (`chip_steps.py` steps
the port on the card against its plain versions with the port's).
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
from hybridquantization_tpu_torch.tools import steps  # noqa: E402


def decisions(errors, current, temperature, u_acc, u_conv, ite, best, sw):
    """`make_step`'s decisions from one iteration's numbers (numpy, f32), with
    JAX's keep probability: `tools.steps.decisions`, which `chip_steps.py`
    calls with the port's."""
    keep_p = np.float32(np.asarray(jschedule.keep_probability(ite, sw.conv_delay, sw.conv_spread, sw.imax)))
    return steps.decisions(errors, current, temperature, u_acc, u_conv, keep_p, best,
                           sw.convergence and len(errors) > 1)


def main(argv=None) -> int:
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import loop
    from hybridquantization_tpu_torch.tools import jax_draws
    from hybridquantization_tpu_torch.tools.parity_check import content_image

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
    pctx = _make_context(img, build_filters(), cfg, "cpu")
    pfit = make_population_fitness(pctx, cfg)
    seen = {}

    def pfitness(p):
        seen["errors"], seen["usage"] = pfit(p)
        return seen["errors"], seen["usage"]

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
    best_at = {"JAX": 0, "port": 0}  # the iteration each side's best was last set (0: init_state)
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
        je, jusage = (np.asarray(x) for x in jfit_jit(jprops))
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
            keep_p = np.float32(np.asarray(jschedule.keep_probability(it, sw.conv_delay, sw.conv_spread, sw.imax)))
            conv = sw.convergence and pop > 1
            view = steps.oracle_view(steps.Judge(img), np.asarray(jprops), np.asarray(jstate.colors),
                                     np.asarray(jstate.best_colors), jT, u_acc, u_conv, keep_p, conv)
            o = np.asarray(view["proposals"])
            print(f"iteration {ite}: first differing decision(s) {differ}")
            for name, dec, err, margin in (("JAX", jd, je, jm), ("port", pd, pe, pm)):
                print(f"  {name:4s} decisions {dec}; proposal errors {err.tolist()}; margins {margin}")
            print(f"  f64 oracle fitness of JAX's proposals {o.tolist()} (least: member {int(np.argmin(o))})")
            sides = [{"errors": e, "current": np.asarray(st.current_errors), "temperature": t, "keep_p": keep_p,
                      "best": float(st.best_error), "decisions": dec}
                     for e, st, t, dec in ((je, jstate, jT, jd),
                                           (pe, pstate, np.float32(pnew.temperature.item()), pd))]
            verdict = steps.classify(*sides, u_acc, u_conv, conv)
            od = view["decisions"]
            side = steps.oracle_side(od, jd, pd, differ)
            side = {"a": "JAX", "b": "port"}.get(side, side)
            print(f"  classified {verdict['class']}: errors read within {verdict['rel_gap']:.2e} relative "
                  f"(limit {steps.ARITH_REL:g}); JAX's state with the port's errors gives the port's "
                  f"decision: {verdict['flip_a']}; the port's state with JAX's errors gives JAX's: "
                  f"{verdict['flip_b']}")
            print(f"  the f64 oracle's decisions from JAX's state {od}: with {side}")
            print(f"  relative error against it: JAX {((je - o) / o).tolist()}, port {((pe - o) / o).tolist()}")
            gap = np.abs(np.asarray(jprops) - port_proposals(pstate, ite, d, sw)).max()
            print(f"  max |JAX proposal - port proposal| {float(gap):.3e}")
            pprops = port_proposals(pstate, ite, d, sw)
            usage_flips(pctx, np.asarray(jprops), pprops, jusage, seen["usage"].numpy(), cfg.precision)
            pj, pju = pfit(torch.from_numpy(np.array(jprops)))
            print(f"  the port's fitness of JAX's proposals {pj.tolist()}; the entries it counts as used differ "
                  f"from JAX's on members {np.flatnonzero((pju.numpy() != jusage).any(-1)).tolist()}")
            jb, pb = np.asarray(jstate.best_colors), pstate.best_colors.numpy()
            print(f"  best so far: JAX {float(jstate.best_error)!r} (set at iteration {best_at['JAX']}), port "
                  f"{float(pstate.best_error)!r} (set at {best_at['port']}); max |JAX best palette - port best "
                  f"palette| {float(np.abs(jb - pb).max()):.3e}")
            jb4 = np.asarray(jfit_jit(jnp.asarray(np.stack([jb] * pop)))[0])
            pb4 = pfit(torch.from_numpy(np.stack([pb] * pop)))[0].numpy()
            print(f"  each best palette judged again in every member's slot: JAX {jb4.tolist()}, "
                  f"port {pb4.tolist()}")
            if ref:
                print(f"  JAX stepped here, its best errors so far within {drift:.2e} relative of its run's")
            return 0
        for name, old, new in (("JAX", float(jstate.best_error), float(jnew.best_error)),
                               ("port", float(pstate.best_error), float(pnew.best_error))):
            if new != old:
                best_at[name] = ite
        if ite % 100 == 0:
            print(f"iteration {ite}: decisions equal so far; max relative error difference "
                  f"{float(np.max(np.abs(je - pe) / je)):.2e}"
                  + (f"; JAX stepped within {drift:.2e} of its run" if ref else ""), flush=True)
        jstate, pstate = jnew, pnew
    print(f"no decision differs through iteration {ite}")
    return 0


def usage_flips(pctx, jprops, pprops, jusage, pusage, precision: str, show: int = 4) -> None:
    """Print, for each proposal whose palette entries JAX and the port count
    as used differently, the entries that differ and how many pixels the
    port's assignment (B1's, as its population fitness runs it) sends to
    each under JAX's proposal and under the port's; and for up to `show` of
    those pixels the f64 squared distances to that entry and to the nearest
    other one under each proposal: a near tie, or not."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops.assign_kernel import assign_opp_usage_pop

    pix = pctx["assign_pixels"]
    pix64 = pix.double()
    for m in np.flatnonzero((jusage != pusage).any(axis=-1)):
        pals = {name: torch.from_numpy(np.array(p[m])) for name, p in (("JAX", jprops), ("port", pprops))}
        idx = {name: assign_opp_usage_pop(pix, pal[None], cs.srgb_to_opp(pal)[None], precision=precision,
                                          return_index=True)[2][0].numpy() for name, pal in pals.items()}
        d2 = {name: ((pix64[:, None, :] - pal.double()[None]) ** 2).sum(-1).numpy() for name, pal in pals.items()}
        gap = float((pals["JAX"] - pals["port"]).abs().max())
        for c in np.flatnonzero(jusage[m] != pusage[m]):
            sent = {name: np.flatnonzero(i == c) for name, i in idx.items()}
            print(f"  member {m}, entry {c}: used by JAX {bool(jusage[m, c])}, by the port {bool(pusage[m, c])}; "
                  f"the port's assignment sends {len(sent['JAX'])} pixel(s) there under JAX's proposal, "
                  f"{len(sent['port'])} under the port's (the proposals {gap:.3e} apart)")
            for p in np.union1d(sent["JAX"], sent["port"])[:show]:
                line = []
                for name, d in d2.items():
                    other = np.delete(d[p], c)
                    k = int(np.argmin(other))
                    k += k >= c
                    line.append(f"under {name}'s proposal {float(d[p, c])!r} to entry {c}, {float(d[p, k])!r} "
                                f"to entry {k} (relative gap {(d[p, c] - d[p, k]) / d[p, k]:.3e})")
                print(f"    pixel {int(p)} {pix[p].tolist()}, f64 squared distances: " + "; ".join(line))


def port_proposals(pstate, ite, d, sw):
    """The port's proposals of this iteration (its `schedule.propose`)."""
    from hybridquantization_tpu_torch.swasa import schedule

    it = torch.tensor(ite, dtype=torch.int32)
    return schedule.propose(pstate.colors, it, sw.s0, sw.beta, sw.imax, d["prop"]).numpy()


if __name__ == "__main__":
    raise SystemExit(main())
