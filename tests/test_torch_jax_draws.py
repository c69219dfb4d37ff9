"""`tools.jax_draws` (JAX's threefry2x32 in NumPy) against `jax.random`, and
the port's anneal fed the JAX engine's own draw stream against JAX's
`find_palette` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import HybridQuantizer as JQuantizer
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu.swasa import loop as jloop
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.swasa import loop as tloop
from hybridquantization_tpu_torch.tools import jax_draws as jd
from tests.test_torch_pipeline import ERR_ATOL, _image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

POP, K, ITERS = 4, 16, 50


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_split_and_uniform_equal_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    _same_bits(jd.prng_key(seed), key)
    for num in (2, 3, 4, 5):
        _same_bits(jd.split(jd.prng_key(seed), num), jax.random.split(key, num))
    for shape, lo, hi in (((POP,), 0.0, 1.0), ((POP, K, 3), -1.0, 1.0), ((5, 7), 0.0, 1.0)):
        want = jax.random.uniform(key, shape, jnp.float32, lo, hi)
        _same_bits(jd.uniform(jd.prng_key(seed), shape, lo, hi), want)
        _same_bits(jd.random_bits(jd.prng_key(seed), shape),
                   jax.random.bits(key, shape))
    # leading key axes: each key's draw on its own
    keys = jd.split(jd.prng_key(seed), 3)
    both = jd.uniform(keys, (K, 3))
    for i in range(3):
        _same_bits(both[i], jax.random.uniform(jnp.asarray(keys[i]), (K, 3)))


def test_seed_out_of_range_is_refused():
    with pytest.raises(ValueError):
        jd.prng_key(-1)


def test_engine_draws_equal_the_jax_engines_stream():
    """The start palettes of JAX's init_state and, over ITERS steps of its
    make_step, each step's draws from the key the step carries."""
    seed = 5
    cfg = JSWASA(num_colors=K, population=POP, imax=ITERS)

    def fit(p):  # draws do not depend on the fitness
        return jnp.zeros(p.shape[0]), jnp.ones(p.shape[:2], bool)

    fit.is_population = True
    state = jloop.init_state(jax.random.PRNGKey(seed), fit, cfg)
    step = jax.jit(jloop.make_step(fit, cfg))
    stream = jd.engine_draws(seed, POP, K, chunk=16)
    _same_bits(next(stream), state.colors)
    for ite in range(1, ITERS + 1):
        _, k_prop, k_acc, k_conv = jax.random.split(state.key, 4)
        got = next(stream)
        _same_bits(got["prop"], jax.random.uniform(k_prop, (POP, K, 3), jnp.float32, -1.0, 1.0))
        _same_bits(got["acc"], jax.random.uniform(k_acc, (POP,)))
        _same_bits(got["conv"], jax.random.uniform(k_conv, (POP,)))
        state, _ = step(state, jnp.int32(ite))


@pytest.mark.parametrize("seed", [3, 11])
def test_port_anneal_on_jax_draws_reproduces_find_palette(seed):
    """The port's make_step, fed engine_draws, ends where JAX's
    find_palette(img, key=PRNGKey(seed)) ends at imax 20 (the 20-step
    test's image and tolerance)."""
    Kc, steps = 8, 20
    img = _image()
    jcfg = JConfig(swasa=JSWASA(num_colors=Kc, population=POP, imax=steps), use_pallas="off")
    _, info = JQuantizer(jcfg).find_palette(img, key=jax.random.PRNGKey(seed), chunk_size=steps)

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=Kc, population=POP, imax=steps))
    fit = make_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)
    stream = jd.engine_draws(seed, POP, Kc)
    state = tloop.init_state(torch.Generator(), fit, cfg.swasa, torch.from_numpy(next(stream)))
    step = tloop.make_step(fit, cfg.swasa)
    for ite in range(1, steps + 1):
        draws = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        state, _ = step(state, torch.tensor(ite, dtype=torch.int32), draws)
    assert float(state.best_error) == pytest.approx(info["best_error"], abs=ERR_ATOL)
    np.testing.assert_allclose(state.best_colors.numpy(), np.asarray(info["state"].best_colors),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [3, 11])
def test_whole_schedule_on_jax_draws_matches_find_palette(seed):
    """A whole imax-200 schedule (hot start, cooling, the convergence gate
    from about 0.75 imax, the cold end) fed JAX's own stream ends where JAX's
    find_palette ends, on the 20-step test's image and tolerance. JAX scores
    in true f32 ("highest"): its CPU "f32x3" is a bf16 split, whose near
    ties break otherwise than the port's fp32 scan on a pixel or two an
    evaluation, and over 200 steps one such flip can turn an acceptance."""
    Kc, imax = 8, 200
    img = _image()
    jcfg = JConfig(swasa=JSWASA(num_colors=Kc, population=POP, imax=imax), use_pallas="off",
                   precision="highest")
    _, info = JQuantizer(jcfg).find_palette(img, key=jax.random.PRNGKey(seed), chunk_size=imax)

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=Kc, population=POP, imax=imax))
    fit = make_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)
    stream = jd.engine_draws(seed, POP, Kc)
    state = tloop.init_state(torch.Generator(), fit, cfg.swasa, torch.from_numpy(next(stream)))
    step = tloop.make_step(fit, cfg.swasa)
    best = []
    for ite in range(1, imax + 1):
        draws = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        state, tel = step(state, torch.tensor(ite, dtype=torch.int32), draws)
        best.append(float(tel[0]))
    # the same palettes at the end, and the same best error at every
    # iteration but where a near tie broke the other way in one evaluation:
    # one pixel of the 5120 moves the mean by at most ~0.03 (its ΔE / P)
    np.testing.assert_allclose(state.colors.numpy(), np.asarray(info["state"].colors), atol=1e-5)
    off = np.abs(np.asarray(best) - info["telemetry"]["best_error"])
    assert (off > ERR_ATOL).mean() <= 0.02 and off.max() < 0.03 and off[-1] <= ERR_ATOL
