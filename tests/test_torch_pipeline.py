"""The port's slices end to end against the JAX engine: 20 annealing steps fed
the same draws, then quantize and error_image; the quality schedule (k-means
seeds, 10 steps, exact polish, dithered quantize, error_image); plus the
engine's own flow (progress, cancel, chunks, resume) and what it does not
port yet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import HybridQuantizer as JQuantizer
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu.ops.kmeans import kmeans_init_palettes as j_kmeans_init
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu.swasa import loop as jloop
from hybridquantization_tpu.swasa.state import state_to_numpy as j_state_to_numpy
from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import convert
from hybridquantization_tpu_torch.cli import main
from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
from hybridquantization_tpu_torch.swasa import loop as tloop

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# 20 steps of f32 fitness values that agree to ~1e-6 (the population-fitness
# tolerance is 2e-5); colors move by draws both sides share, so they agree to
# f32 rounding. error_image is one f32 S-CIELAB pass on each side.
ERR_ATOL = 2e-5
COLOR_ATOL = 1e-5
MEAN_DE_RTOL = 1e-5


def _image(h=64, w=80, seed=0):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x / w, y / h, 0.5 + 0.25 * np.sin(x / 5.0) * np.cos(y / 7.0)], -1)
    noise = np.random.default_rng(seed).normal(scale=0.05, size=(h, w, 3))
    return np.clip(base + noise, 0, 1).astype(np.float32)


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_twenty_step_slice_matches_jax(space):
    K, pop, steps = 8, 4, 20
    img = _image()
    jcfg = JConfig(
        swasa=JSWASA(num_colors=K, population=pop, imax=steps), use_pallas="off",
        assignment_space=space,
    )
    jq = JQuantizer(jcfg)
    jctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    jfit = j_pop_fitness(jctx, jcfg, jq.filters.half_width)
    jstep = jax.jit(jloop.make_step(jfit, jcfg.swasa))
    jstate = jloop.init_state(jax.random.PRNGKey(3), jfit, jcfg.swasa)

    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=pop, imax=steps), assignment_space=space
    )
    q = HybridQuantizer(cfg, device="cpu")
    fit = make_population_fitness(_make_context(img, q.filters, cfg, "cpu"), cfg)
    tstep = tloop.make_step(fit, cfg.swasa)
    state = convert.state_from_jax_numpy(j_state_to_numpy(jstate))

    j_best, t_best = [], []
    for ite in range(1, steps + 1):
        _, k_prop, k_acc, k_conv = jax.random.split(jstate.key, 4)
        draws = {
            "prop": jax.random.uniform(k_prop, (pop, K, 3), jnp.float32, -1.0, 1.0),
            "acc": jax.random.uniform(k_acc, (pop,)),
            "conv": jax.random.uniform(k_conv, (pop,)),
        }
        jstate, jtel = jstep(jstate, jnp.int32(ite))
        state, tel = tstep(
            state, torch.tensor(ite, dtype=torch.int32),
            {k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        )
        j_best.append(float(jtel["best_error"]))
        t_best.append(float(tel[0]))

    np.testing.assert_allclose(t_best, j_best, rtol=0, atol=ERR_ATOL)
    assert all(b <= a for a, b in zip(t_best, t_best[1:]))
    np.testing.assert_allclose(state.colors.numpy(), np.asarray(jstate.colors), atol=COLOR_ATOL)
    palette = state.best_colors
    np.testing.assert_allclose(palette.numpy(), np.asarray(jstate.best_colors), atol=COLOR_ATOL)

    # quantize and error_image on the same palette
    j_out = np.asarray(jq.quantize(img, np.asarray(palette)))
    out = q.quantize(img, palette)
    np.testing.assert_array_equal(out.numpy(), j_out)
    assert len(np.unique(out.reshape(-1, 3).numpy(), axis=0)) <= K
    j_mean, j_viz = jq.error_image(img, j_out)
    mean, viz = q.error_image(img, out)
    assert float(mean) == pytest.approx(float(j_mean), rel=MEAN_DE_RTOL)
    assert viz.shape == (64, 80, 3)
    np.testing.assert_allclose(viz.numpy(), np.asarray(j_viz), rtol=0, atol=1e-5)


def test_scielab_matches_jax():
    img = _image(40, 44, seed=2)
    want = np.asarray(JQuantizer(JConfig()).scielab(img))
    got = HybridQuantizer(QuantizationConfig(), device="cpu").scielab(img).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _small(imax=12, **kw):
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=5, population=3, imax=imax), **kw)
    return HybridQuantizer(cfg, device="cpu"), _image(24, 28, seed=4)


def test_run_flow_progress_and_telemetry():
    q, img = _small(progress_every=5)
    calls = []
    out, info = q.run(img, progress=lambda d, n, t: calls.append((d, n, t)))
    assert [c[0] for c in calls] == [5, 10, 12] and all(c[1] == 12 for c in calls)
    assert {"best_error", "mean_error", "min_error", "std_error", "eta_s"} <= calls[-1][2].keys()
    tel = info["telemetry"]
    assert all(len(v) == 12 for v in tel.values())
    assert np.all(np.diff(tel["best_error"]) <= 0)
    assert info["best_error"] == pytest.approx(float(tel["best_error"][-1]))
    assert info["iterations"] == 12 and int(info["state"].iteration) == 12
    assert out.shape == img.shape and np.isfinite(out.numpy()).all()
    assert len(np.unique(out.reshape(-1, 3).numpy(), axis=0)) <= 5
    torch.testing.assert_close(info["palette"], info["state"].best_colors)


def test_progress_can_stop_the_search():
    q, img = _small(imax=50)
    _, info = q.find_palette(img, progress=lambda d, n, t: d < 20, chunk_size=10)
    assert info["iterations"] == 20


def test_resume_continues_the_same_run():
    q, img = _small(imax=10)
    _, full = q.find_palette(img, chunk_size=4)
    _, half = q.find_palette(img, chunk_size=3, progress=lambda d, n, t: d < 6)
    assert half["iterations"] == 6
    _, rest = q.find_palette(img, initial_state=half["state"], chunk_size=4)
    assert rest["iterations"] == 10
    torch.testing.assert_close(rest["state"].colors, full["state"].colors, rtol=0, atol=0)
    assert rest["best_error"] == full["best_error"]


def test_seeded_runs_repeat():
    q, img = _small(imax=6)
    a, _ = q.find_palette(img)
    b, _ = q.find_palette(img)
    c, _ = q.find_palette(img, generator=torch.Generator().manual_seed(123))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


@pytest.mark.parametrize(
    "call",
    [
        lambda q, img: QuantizationConfig(precision="bf16"),
        lambda q, img: QuantizationConfig(tie_mode="average", init="kmeans"),
        lambda q, img: QuantizationConfig(conv_precision="bf16"),
    ],
)
def test_unported_features_raise(call, tmp_path):
    """The fast modes (once ROADMAP A11) run; only more than one GPU is
    refused, naming A13."""
    q, img = _small()
    cfg = dataclasses.replace(call(q, img), swasa=q.config.swasa)
    _, info = HybridQuantizer(cfg, device="cpu").find_palette(img)
    assert np.isfinite(info["best_error"]) and info["iterations"] == cfg.swasa.imax
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        main(["quantize-batch", "a.ppm", "--out-dir", str(tmp_path), "--mesh-pixel", "2"], device="cpu")


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_quality_schedule_slice_matches_jax(space):
    """JAX's k-means seeds as the initial palettes, 10 steps on shared draws,
    then the exact polish, a dithered quantize and error_image."""
    K, pop, steps = 8, 4, 10
    img = _image(48, 56, seed=6)
    jcfg = JConfig(
        swasa=JSWASA(num_colors=K, population=pop, imax=steps), use_pallas="off",
        assignment_space=space, init="kmeans",
    )
    jq = JQuantizer(jcfg)
    jfit = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg, jq.filters.half_width)
    jstep = jax.jit(jloop.make_step(jfit, jcfg.swasa))
    seeds = j_kmeans_init(jax.random.PRNGKey(1), jnp.asarray(img).reshape(-1, 3), K, pop)
    jstate = jloop.init_state(jax.random.PRNGKey(2), jfit, jcfg.swasa, seeds)

    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=pop, imax=steps), assignment_space=space,
        init="kmeans",
    )
    q = HybridQuantizer(cfg, device="cpu")
    fit = make_population_fitness(_make_context(img, q.filters, cfg, "cpu"), cfg)
    state = tloop.init_state(torch.Generator(), fit, cfg.swasa, torch.from_numpy(np.array(seeds)))
    np.testing.assert_allclose(
        state.current_errors.numpy(), np.asarray(jstate.current_errors), rtol=0, atol=ERR_ATOL
    )
    tstep = tloop.make_step(fit, cfg.swasa)
    for ite in range(1, steps + 1):
        _, k_prop, k_acc, k_conv = jax.random.split(jstate.key, 4)
        draws = {
            "prop": jax.random.uniform(k_prop, (pop, K, 3), jnp.float32, -1.0, 1.0),
            "acc": jax.random.uniform(k_acc, (pop,)),
            "conv": jax.random.uniform(k_conv, (pop,)),
        }
        jstate, _ = jstep(jstate, jnp.int32(ite))
        state, _ = tstep(
            state, torch.tensor(ite, dtype=torch.int32),
            {k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        )
    np.testing.assert_allclose(state.best_colors.numpy(), np.asarray(jstate.best_colors), atol=COLOR_ATOL)
    assert float(state.best_error) == pytest.approx(float(jstate.best_error), abs=ERR_ATOL)

    j_pal = np.asarray(jq.polish(img, np.asarray(jstate.best_colors), iters=10))
    pal = q.polish(img, state.best_colors, iters=10)
    np.testing.assert_allclose(pal.numpy(), j_pal, rtol=0, atol=COLOR_ATOL)
    j_out = np.asarray(jq.quantize(img, j_pal, dither=0.5))
    out = q.quantize(img, j_pal, dither=0.5)
    np.testing.assert_array_equal(out.numpy(), j_out)  # no perturbed pixel is a near tie here
    j_mean, _ = jq.error_image(img, j_out)
    mean, _ = q.error_image(img, j_out)
    assert float(mean) == pytest.approx(float(j_mean), rel=MEAN_DE_RTOL)
