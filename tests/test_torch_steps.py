"""`tools.steps` (the anneal's decisions recomputed, and a parting
classified) and `chip_steps.py`'s stepper, both sides on the CPU at a tiny
size."""

import numpy as np
import pytest
import torch

import chip_steps
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.swasa import schedule
from hybridquantization_tpu_torch.tools import steps
from hybridquantization_tpu_torch.tools.parity_check import content_image
from tests import jax_cpu_steps

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

SIZE, K, IMAX, SEED = 64, 8, 40, 0
SCALE = 1 + 1e-3


def _port_keep_p(ite, sw):
    it = torch.tensor(ite, dtype=torch.int32)
    return np.float32(schedule.keep_probability(it, sw.conv_delay, sw.conv_spread, sw.imax).item())


@pytest.mark.parametrize("pop", [1, 4, 8])
def test_decisions_are_jax_cpu_steps_decisions(pop):
    """The port's jax-free `decisions`, with the port's keep probability and
    with JAX's, equals `tests/jax_cpu_steps.decisions` on random numbers."""
    from hybridquantization_tpu import SWASAConfig as JSWASA

    sw = JSWASA(num_colors=K, population=pop, imax=1500)
    rng = np.random.default_rng(pop)
    taken = {k: set() for k in steps.DECISIONS}
    for _ in range(200):
        errors = rng.uniform(8, 12, pop).astype(np.float32)
        current = (errors + rng.normal(0, 0.05, pop)).astype(np.float32)
        temperature = np.float32(rng.uniform(1e-3, 0.5))
        u_acc, u_conv = rng.random(pop, dtype=np.float32), rng.random(pop, dtype=np.float32)
        ite = int(rng.integers(1, sw.imax + 1))
        best = float(np.float32(rng.uniform(8, 12)))
        want, want_m = jax_cpu_steps.decisions(errors, current, temperature, u_acc, u_conv, ite, best, sw)
        jax_p = np.float32(np.asarray(jax_cpu_steps.jschedule.keep_probability(ite, sw.conv_delay,
                                                                               sw.conv_spread, sw.imax)))
        for keep_p in (_port_keep_p(ite, sw), jax_p):
            got, got_m = steps.decisions(errors, current, temperature, u_acc, u_conv, keep_p, best,
                                         sw.convergence and pop > 1)
            assert steps.differing(got, want) == []
            np.testing.assert_array_equal(got_m["boltzmann - u"], want_m["boltzmann - u"])
        for k in steps.DECISIONS:
            taken[k].add(str(want[k]))
    assert all(len(v) > 1 for k, v in taken.items() if pop > 1 or k in ("accept", "best"))  # each varies


def _cfg():
    return QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=4, imax=IMAX))


def test_the_stepper_finds_no_parting_between_two_cpu_sides():
    img = content_image("natural", SIZE)
    rec = chip_steps.step_pair(img, _cfg(), SEED, ("cpu", "cpu"), log=lambda line: None)
    assert rec["parting"] is None and rec["through"] == IMAX
    assert rec["final_deltaE"]["card"] == rec["final_deltaE"]["plain"]
    assert np.isfinite(rec["final_deltaE"]["card"])


def _first_flip(img, cfg):
    """The first (iteration, member, decisions) at which one member's error
    scaled by SCALE changes a decision of the unperturbed anneal."""
    side = chip_steps.Side("plain", img, cfg, "cpu", SEED)
    sw = cfg.swasa
    for ite in range(1, sw.imax + 1):
        draws = next(side.stream)
        n = side.step(ite, draws)
        for m in range(sw.population):
            e = torch.from_numpy(n["errors"].copy())
            e[m] *= SCALE
            d, _ = steps.decisions(e.numpy(), n["current"], n["temperature"], draws["acc"], draws["conv"],
                                   n["keep_p"], n["best"])
            names = steps.differing(n["decisions"], d)
            if names:
                return ite, m, names
    raise AssertionError("no single scaled error flips a decision")


def test_the_stepper_stops_where_one_side_s_errors_are_scaled():
    """From iteration k on, the plain side's error of one member is scaled
    by 1 + 1e-3: the stepper stops at k, names the decision, and calls it
    logic (1e-3 is beyond the arithmetic limit)."""
    img = content_image("natural", SIZE)
    cfg = _cfg()
    k, m, names = _first_flip(img, cfg)

    def wrap(fit):
        calls = [0]  # call 0 is init_state's, call i is iteration i

        def scaled(p):
            e, usage = fit(p)
            if calls[0] >= k:
                e = e.clone()
                e[m] *= SCALE
            calls[0] += 1
            return e, usage

        return scaled

    rec = chip_steps.step_pair(img, cfg, SEED, ("cpu", "cpu"), to_end=True, wraps=(None, wrap),
                               log=lambda line: None)
    p = rec["parting"]
    assert p["iteration"] == k and p["decisions"] == names
    assert p["class"] == "logic" and p["rel_gap"] == pytest.approx(1e-3, rel=1e-3)
    assert p["oracle_side"] in ("card", "plain", "both", "neither", "split")
    assert rec["through"] == IMAX and set(rec["final_deltaE"]) == {"card", "plain"}  # stepped on to imax
    assert p["oracle"]["from_card_state"]["with"] in ("card", "both")  # the card side is the unscaled one


def _side(errors, current, decide=None, keep_p=0.3, best=20.0, temperature=0.05, u_acc=None, u_conv=None):
    errors, current = np.float32(errors), np.float32(current)
    n = {"errors": errors, "current": current, "temperature": np.float32(temperature),
         "keep_p": np.float32(keep_p), "best": np.float32(best)}
    n["decisions"] = (decide or steps.decisions)(errors, current, n["temperature"], u_acc, u_conv,
                                                 n["keep_p"], n["best"])[0]
    return n


U_ACC = np.float32([0.5, 0.5, 0.5, 0.5])
U_CONV = np.float32([0.9, 0.1, 0.9, 0.9])  # members 0, 2, 3 lose their keep draw: a convergence source


def test_a_near_tie_flip_is_arithmetic():
    """Two proposals 5e-7 apart; one side's error of the second 1e-6 lower
    flips the convergence source and the best update."""
    current = [11.2, 11.2, 11.2, 11.2]
    errors = np.float32([11.0786, 11.0786, 11.12, 11.09])
    errors[1] *= np.float32(1 + 5e-7)
    b_errors = errors.copy()
    b_errors[1] *= np.float32(1 - 1e-6)
    a = _side(errors, current, u_acc=U_ACC, u_conv=U_CONV)
    b = _side(b_errors, current, u_acc=U_ACC, u_conv=U_CONV)
    got = steps.classify(a, b, U_ACC, U_CONV)
    assert got["decisions"] == ["source", "best"]
    assert got["class"] == "arithmetic" and got["flip_a"] and got["flip_b"]
    assert got["rel_gap"] < 2e-6


def test_equal_errors_with_a_changed_acceptance_comparison_is_logic():
    """Both sides see the same errors; one side's Metropolis comparison is
    turned round (exp(-gap/T) < u), so it refuses an uphill proposal the
    engine takes."""
    errors, current = [11.01, 12.5, 12.0, 13.0], [11.0, 12.0, 12.0, 12.0]

    def turned(e, c, t, ua, uc, kp, best):
        d, margins = steps.decisions(e, c, t, ua, uc, kp, best)
        d["accept"] = ((e - c) <= 0) | (np.exp(-(e - c) / t) < ua)
        return d, margins

    a = _side(errors, current, u_acc=U_ACC, u_conv=U_CONV)
    b = _side(errors, current, decide=turned, u_acc=U_ACC, u_conv=U_CONV)
    got = steps.classify(a, b, U_ACC, U_CONV)
    assert "accept" in got["decisions"] and got["rel_gap"] == 0.0
    assert got["class"] == "logic" and not got["flip_a"] and not got["flip_b"]


def test_the_jax_stepper_names_an_entry_used_on_one_side_only(capsys):
    """`jax_cpu_steps.usage_flips`: an entry that one side counts as used
    and the other not is named, with the pixels the port's assignment
    sends there and their f64 distances to it and to the nearest other
    entry under each side's proposal."""
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters

    img = content_image("natural", 16)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=2, imax=10))
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    props = np.random.default_rng(0).random((2, 4, 3)).astype(np.float32)
    _, usage = make_population_fitness(ctx, cfg)(torch.from_numpy(props))
    pusage = usage.numpy()
    (used,) = np.flatnonzero(pusage[1])[:1]
    jusage = pusage.copy()
    jusage[1, used] = False
    jax_cpu_steps.usage_flips(ctx, props, props, jusage, pusage, cfg.precision, show=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"  member 1, entry {used}: used by JAX False, by the port True; ")
    assert out[0].endswith("(the proposals 0.000e+00 apart)")
    assert len(out) == 3 and all(line.startswith("    pixel ") for line in out[1:])
