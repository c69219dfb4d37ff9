"""The torch port's SWASA schedule, state and step against the JAX package,
fed the same uniform draws that the JAX `make_step` makes from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu.swasa import loop as jloop
from hybridquantization_tpu.swasa import schedule as jsched
from hybridquantization_tpu.swasa.state import state_to_numpy as j_state_to_numpy
from hybridquantization_tpu_torch import convert
from hybridquantization_tpu_torch.config import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.swasa import loop as tloop
from hybridquantization_tpu_torch.swasa import schedule as tsched
from hybridquantization_tpu_torch.swasa.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py


def _ite(i):
    return torch.tensor(i, dtype=torch.int32)


@pytest.mark.parametrize("i", [0, 1, 19, 20, 100, 2500, 5000])
def test_schedule_scalars_match_jax(i):
    ji = jnp.int32(i)
    assert float(tsched.max_step_width(_ite(i), 100.0, 5.3, 5000)) == float(
        jsched.max_step_width(ji, 100.0, 5.3, 5000)
    )
    t = torch.tensor(20.0)
    assert float(tsched.cool_temperature(t, _ite(i), 20, 0.9)) == float(
        jsched.cool_temperature(jnp.float32(20.0), ji, 20, 0.9)
    )
    assert float(tsched.keep_probability(_ite(i), 0.75, 0.15, 5000)) == pytest.approx(
        float(jsched.keep_probability(ji, 0.75, 0.15, 5000)), rel=1e-6, abs=1e-7
    )


def test_propose_accept_keep_match_jax_on_the_same_draws():
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    colors = jax.random.uniform(k1, (4, 9, 3))
    noise = jax.random.uniform(k2, colors.shape, colors.dtype, -1.0, 1.0)
    want = jsched.propose(k2, colors, 7, 100.0, 5.3, 50)
    got = tsched.propose(torch.tensor(np.asarray(colors)), _ite(7), 100.0, 5.3, 50,
                         torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)

    de = jnp.asarray([-1.0, 0.0, 0.5, 3.0, 1e-3, 20.0], jnp.float32)
    u = jax.random.uniform(k3, de.shape)
    want = jsched.accept(k3, de, jnp.float32(2.0))
    got = tsched.accept(torch.tensor(np.asarray(de)), torch.tensor(2.0), torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want = jsched.keeps_values(k3, 40, 0.75, 0.15, 50, (6,))
    got = tsched.keeps_values(_ite(40), 0.75, 0.15, 50, torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    usage = np.array([[True, False, False, True], [True] * 4])
    np.testing.assert_array_equal(
        tsched.unused_penalty(torch.tensor(usage), 2.0).numpy(),
        [float(jsched.unused_penalty(jnp.asarray(u_), 2.0)) for u_ in usage],
    )


def _jax_draws(state, pop, K):
    """The draws JAX make_step takes from state.key (loop.py:100-135)."""
    _, k_prop, k_acc, k_conv = jax.random.split(state.key, 4)
    return {
        "prop": np.array(jax.random.uniform(k_prop, (pop, K, 3), jnp.float32, -1.0, 1.0)),
        "acc": np.array(jax.random.uniform(k_acc, (pop,))),
        "conv": np.array(jax.random.uniform(k_conv, (pop,))),
    }


def _setup(H=48, W=56, K=6, pop=4, imax=20, seed=0):
    img = np.random.default_rng(seed).random((H, W, 3), dtype=np.float32)
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=pop, imax=imax), use_pallas="off")
    jq = JQuantizer(jcfg)
    jctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    jfit = j_pop_fitness(jctx, jcfg, jq.filters.half_width)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=pop, imax=imax))
    fit = make_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)
    return jcfg, jfit, cfg, fit


def _assert_state_close(t, j):
    jd = j_state_to_numpy(j)
    np.testing.assert_allclose(t.colors.numpy(), jd["colors"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.current_errors.numpy(), jd["current_errors"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(t.best_colors.numpy(), jd["best_colors"], rtol=0, atol=1e-6)
    assert float(t.best_error) == pytest.approx(float(jd["best_error"]), abs=2e-5)
    assert float(t.temperature) == float(jd["temperature"])
    assert int(t.iteration) == int(jd["iteration"])


@pytest.mark.parametrize("ite", [1, 20])
def test_one_step_matches_jax_on_the_same_draws(ite):
    """ite=20 cools the temperature and, at imax=20, keeps a member with
    probability ~0.03: the convergence step copies the best proposal."""
    jcfg, jfit, cfg, fit = _setup()
    jstate = jloop.init_state(jax.random.PRNGKey(5), jfit, jcfg.swasa)
    jstate = jstate.replace(iteration=jnp.int32(ite - 1))
    state = convert.state_from_jax_numpy(j_state_to_numpy(jstate))
    _assert_state_close(state, jstate)

    draws = _jax_draws(jstate, 4, 6)
    jnew, jtel = jax.jit(jloop.make_step(jfit, jcfg.swasa))(jstate, jnp.int32(ite))
    new, tel = tloop.make_step(fit, cfg.swasa)(
        state, _ite(ite), {k: torch.from_numpy(v) for k, v in draws.items()}
    )
    _assert_state_close(new, jnew)
    for i, k in enumerate(tloop.TELEMETRY):
        assert float(tel[i]) == pytest.approx(float(jtel[k]), abs=2e-5), k

    # std is the population (ddof 0) one, like jnp.std
    errors, _ = fit(tsched.propose(state.colors, _ite(ite), 100.0, 5.3, 20,
                                   torch.from_numpy(draws["prop"])))
    assert float(tel[3]) == pytest.approx(float(jnp.std(jnp.asarray(errors.numpy()))), rel=1e-6)
    if ite == 20:
        prop = tsched.propose(state.colors, _ite(ite), 100.0, 5.3, 20,
                              torch.from_numpy(draws["prop"]))
        keep = tsched.keeps_values(_ite(ite), 0.75, 0.15, 20, torch.from_numpy(draws["conv"]))
        assert not keep.all()
        best = int(torch.argmin(errors))
        for p in np.flatnonzero(~keep.numpy()):
            torch.testing.assert_close(new.colors[p], prop[best], rtol=0, atol=0)
            assert float(new.current_errors[p]) == float(errors[best])


def test_step_draws_from_the_generator_without_draws():
    _, _, cfg, fit = _setup(H=24, W=30, K=4, pop=3)
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    s1 = tloop.init_state(g1, fit, cfg.swasa)
    s2 = tloop.init_state(g2, fit, cfg.swasa)
    step = tloop.make_step(fit, cfg.swasa)
    a, _ = step(s1, _ite(1))
    b, _ = step(s2, _ite(1), tsched.draw_step(g2, 3, 4))
    torch.testing.assert_close(a.colors, b.colors, rtol=0, atol=0)


def test_state_numpy_round_trip_keeps_the_stream():
    _, _, cfg, fit = _setup(H=24, W=30, K=4, pop=3)
    s = tloop.init_state(torch.Generator().manual_seed(1), fit, cfg.swasa)
    s, _ = tloop.run_chunk(s, fit, cfg.swasa, 3)
    d = state_to_numpy(s)
    r = state_from_numpy(d)
    for k in ("colors", "current_errors", "best_colors", "best_error", "temperature", "iteration"):
        torch.testing.assert_close(getattr(r, k), getattr(s, k), rtol=0, atol=0)
    a, ta = tloop.run_chunk(s, fit, cfg.swasa, 2)
    b, tb = tloop.run_chunk(r, fit, cfg.swasa, 2)
    torch.testing.assert_close(a.colors, b.colors, rtol=0, atol=0)
    np.testing.assert_array_equal(ta["best_error"], tb["best_error"])
    assert int(a.iteration) == 5


def test_state_from_jax_numpy_seeds_from_the_key():
    jcfg, jfit, _, _ = _setup(H=24, W=30, K=4, pop=2)
    d = j_state_to_numpy(jloop.init_state(jax.random.PRNGKey(77), jfit, jcfg.swasa))
    a, b = convert.state_from_jax_numpy(d), convert.state_from_jax_numpy(d)
    torch.testing.assert_close(
        torch.rand(5, generator=a.generator), torch.rand(5, generator=b.generator)
    )
    assert a.iteration.dtype == torch.int32 and a.colors.dtype == torch.float32
