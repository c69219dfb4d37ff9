"""The anneal's decisions, recomputed from one iteration's numbers, and how a
decision that two stepped anneals take differently is classified.

`swasa.loop.make_step` takes four decisions an iteration: acceptance per
member (Metropolis), the convergence keep per member, the convergence
source (the proposal with the least error, copied over the members that
lose their keep draw) and the best update (the accepted proposal with the
least error, where it beats the best so far). `decisions` recomputes them
in NumPy from the proposals' errors, the members' current errors, the
cooled temperature, the iteration's two uniform draws, the keep
probability and the best error, with the margin each was taken by. It
takes the keep probability as a number, so a stepper computes it with its
own engine's schedule: `tests/jax_cpu_steps.py` with JAX's,
`chip_steps.py` with the port's.

`classify` reads the first decision on which two stepped anneals (sides
"a" and "b", each following its own decisions) differ:

  - "arithmetic" when the errors that decision reads (the proposals'
    errors of the members involved, and for an acceptance those members'
    current errors) differ by at most ARITH_REL relative between the sides,
    and the decision recomputed from one side's state and draws with the
    other side's errors gives the other side's decision: the errors alone
    flip it;
  - "logic" otherwise.

ARITH_REL is twice the port's largest fitness gap to JAX's at layer 2
(1.14e-5, from near-tie pixels).

`Judge` is the f64 oracle's fitness of a palette (`tests/oracle.py`), and
`oracle_view` the decisions recomputed from the oracle's fitness of one
side's proposals, current palettes and best palette: the side of a parting
the oracle takes. NumPy only (the oracle adds SciPy).
"""

from __future__ import annotations

import numpy as np

#: the decisions `decisions` returns, in `make_step`'s order
DECISIONS = ("accept", "keep", "source", "best")
#: "arithmetic" needs the errors a differing decision reads within this relative gap
ARITH_REL = 2e-5


def decisions(errors, current, temperature, u_acc, u_conv, keep_p, best, convergence: bool = True):
    """`make_step`'s decisions from one iteration's numbers (numpy, f32):
    {"accept": (pop,) bool, "keep": (pop,) bool, "source": the convergence
    source or None when no member is overwritten, "best": the improving
    member or None}, and the margins they were taken by.

    keep_p: the convergence keep probability of this iteration (the
    engine's `schedule.keep_probability`); convergence: whether the
    population converges at all (`cfg.convergence` and pop > 1)."""
    errors = np.asarray(errors, np.float32)
    gap = errors - np.asarray(current, np.float32)
    with np.errstate(over="ignore", divide="ignore"):
        boltz = np.exp(-gap / np.float32(temperature))
    accept = (gap <= 0) | (boltz > u_acc)
    keep_p = np.float32(keep_p)
    keep = keep_p > u_conv if convergence else np.ones(len(errors), bool)
    cand = np.where(accept, errors, np.inf)
    m = int(np.argmin(cand))
    order = np.sort(errors)
    return ({"accept": accept, "keep": keep, "source": None if keep.all() else int(np.argmin(errors)),
             "best": m if cand[m] < np.float32(best) else None},
            {"boltzmann - u": boltz - u_acc, "keep p - u": keep_p - u_conv,
             "least two errors": order[:2].tolist()})


def differing(da: dict, db: dict) -> list:
    """The names of the decisions on which two `decisions` results differ."""
    return [k for k in DECISIONS if not np.array_equal(da[k], db[k])]


def involved(name: str, da: dict, db: dict, pop: int) -> list:
    """The members whose errors decision `name` reads: for an acceptance
    the members accepted differently, for the source and the best update
    every member (an argmin reads them all), for the keep none."""
    if name == "accept":
        return [int(i) for i in np.flatnonzero(da["accept"] != db["accept"])]
    if name == "keep":
        return []
    return list(range(pop))


def rel_gap(a, b, members) -> float:
    """The largest |a - b| / |b| over `members` (0 for none)."""
    if not members:
        return 0.0
    a, b = (np.asarray(x, np.float64)[members] for x in (a, b))
    return float(np.max(np.abs(a - b) / np.abs(b)))


def classify(a: dict, b: dict, u_acc, u_conv, convergence: bool = True) -> dict:
    """The first differing decision of two sides, classified.

    a, b: each side's numbers of the iteration, {"errors", "current",
    "temperature", "keep_p", "best"} as `decisions` takes them, and
    "decisions", the decisions that side took. Returns {"decisions": the
    differing names, "class": "arithmetic" or "logic", "rel_gap": the
    largest relative gap of the errors read, "flip_a": the decisions
    recomputed from a's state give a's with a's errors and b's with b's
    errors, "flip_b": the same from b's state}."""
    da, db = a["decisions"], b["decisions"]
    names = differing(da, db)
    pop = len(a["errors"])
    gap = 0.0
    for name in names:
        members = involved(name, da, db, pop)
        gap = max(gap, rel_gap(a["errors"], b["errors"], members))
        if name == "accept":
            gap = max(gap, rel_gap(a["current"], b["current"], members))

    def flips(own, other):
        """`own`'s decisions recomputed from its state give its own with its
        errors and the other side's with the other side's errors."""
        def recompute(errors):
            d, _ = decisions(errors, own["current"], own["temperature"], u_acc, u_conv, own["keep_p"],
                             own["best"], convergence)
            return d

        mine, theirs = recompute(own["errors"]), recompute(other["errors"])
        return all(np.array_equal(mine[k], own["decisions"][k]) and
                   np.array_equal(theirs[k], other["decisions"][k]) for k in names)

    flip_a, flip_b = flips(a, b), flips(b, a)
    arithmetic = bool(names) and gap <= ARITH_REL and (flip_a or flip_b)
    return {"decisions": names, "class": "arithmetic" if arithmetic else "logic", "rel_gap": gap,
            "flip_a": flip_a, "flip_b": flip_b}


def oracle_side(do: dict, da: dict, db: dict, names) -> str:
    """Which side's decisions the oracle's recomputed decisions `do` take
    on `names`: "a", "b", "both" or "neither"."""
    with_a = all(np.array_equal(do[k], da[k]) for k in names)
    with_b = all(np.array_equal(do[k], db[k]) for k in names)
    return {(True, False): "a", (False, True): "b", (True, True): "both"}.get((with_a, with_b), "neither")


class Judge:
    """The f64 oracle's fitness of a palette on `img` (an sRGB image)."""

    def __init__(self, img):
        from .parity_check import judge_filters, judge_target, load_oracle

        self.oracle, self.filters = load_oracle(), judge_filters()
        self.img64, self.target = img.astype(np.float64), judge_target(img)

    def __call__(self, palette) -> float:
        return float(self.oracle.fitness(self.img64, self.target, np.asarray(palette, np.float64),
                                         *self.filters))


def oracle_view(judge, proposals, colors, best_colors, temperature, u_acc, u_conv, keep_p,
                convergence: bool = True) -> dict:
    """The oracle's fitness of one side's `proposals`, current palettes
    `colors` and best palette, and the decisions recomputed from them with
    that side's temperature and keep probability and the iteration's draws:
    {"proposals", "current", "best", "decisions"}."""
    props = [judge(p) for p in proposals]
    cur = [judge(c) for c in colors]
    best = judge(best_colors)
    d, _ = decisions(np.float32(props), np.float32(cur), temperature, u_acc, u_conv, keep_p, np.float32(best),
                     convergence)
    return {"proposals": props, "current": cur, "best": best, "decisions": d}
