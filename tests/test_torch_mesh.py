"""The port's multi-device engine on 2 and 4 gloo ranks on the CPU, against
the JAX package under shard_map on conftest's virtual devices and against
the one-device engine.

The ranks run tests/_torch_mesh_worker.py's `rank_checks`, started once per
group size by the port's launcher; each test reads its part of their
results. Row and column pieces are held to JAX's on the same inputs; the
engine (k-means, 6 iterations, polish 2, quantize, error images) to
`BatchQuantizer` and `HybridQuantizer.error_image`; the ranks of a group to
each other, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu.parallel import DATA_AXIS as J_DATA
from hybridquantization_tpu.parallel import ShardedBatchQuantizer as JBatch
from hybridquantization_tpu.parallel import PIXEL_AXIS as J_PIXEL
from hybridquantization_tpu.parallel import build_sharded_fast_fns as j_fast_fns
from hybridquantization_tpu.parallel import conv1d_vertical_sharded as j_conv_v
from hybridquantization_tpu.parallel import exchange_row_halos as j_halos
from hybridquantization_tpu.parallel import fast as j_fast
from hybridquantization_tpu.parallel import make_mesh as j_make_mesh
from hybridquantization_tpu.parallel import make_strip_fitness as j_strip_fitness
from hybridquantization_tpu.parallel import strip_scielab as j_strip_scielab
from hybridquantization_tpu.scielab import build_filters as j_build_filters
from hybridquantization_tpu.scielab import transform as jsct
from hybridquantization_tpu_torch import HybridQuantizer
from hybridquantization_tpu_torch.parallel import BatchQuantizer, make_mesh
from hybridquantization_tpu_torch.parallel.fast import make_fast_fitness, shard_context
from hybridquantization_tpu_torch.parallel.multihost import launch
from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
from hybridquantization_tpu_torch.scielab.filters import build_filters

from . import _torch_mesh_worker as w

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

ERR_ATOL = 1e-5   # fitness: f32 on both sides, in other summation orders
# S-CIELAB values up to ~100 (one f32 ulp 7.6e-6), JAX's banded matmuls
# against the port's tap-by-tap filter
LAB_ATOL = 1e-4
CONV_ATOL = 1e-5  # the plain filters of values in [0, 1)
ENGINE_ATOL = 2e-5  # palettes and best errors between paths, tests/test_sharding.py:443-446
DE_RTOL = 1e-5
WP = jnp.asarray([0.95047, 1.0, 1.0883])


@functools.lru_cache(maxsize=None)
def _ranks(n: int) -> list:
    return launch(w.rank_checks, n, (n,), device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request):
    return request.param, _ranks(request.param)


def _rows_of(results, key, axis):
    """The ranks' strips of a row check, concatenated along their rows."""
    return np.concatenate([r["rows"][key] for r in results], axis=axis)


def _jax_sm(n, body, in_specs, out_specs, *args):
    return jax.jit(shard_map(body, mesh=j_make_mesh(1, n), in_specs=in_specs, out_specs=out_specs))(*args)


def _same_on_every_rank(results, section):
    for r in results[1:]:
        for k, v in r[section].items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(results[0][section][k]), err_msg=k)


def test_row_halos_match_jax(group):
    n, results = group
    x = jnp.asarray(w.halo_input())
    spec = P(None, J_PIXEL, None)
    top, bottom = _jax_sm(n, lambda s: j_halos(s, w.HALO, J_PIXEL), (spec,), (spec, spec), x)
    np.testing.assert_array_equal(_rows_of(results, "halo_top", 1), np.asarray(top))
    np.testing.assert_array_equal(_rows_of(results, "halo_bottom", 1), np.asarray(bottom))


def test_vertical_conv_matches_jax(group):
    n, results = group
    spec = P(None, J_PIXEL, None)
    k = jnp.asarray(w.conv_kernels())
    want = _jax_sm(n, lambda s: j_conv_v(s, k, J_PIXEL), (spec,), spec, jnp.asarray(w.halo_input()))
    np.testing.assert_allclose(_rows_of(results, "conv_v", 1), np.asarray(want), rtol=0, atol=CONV_ATOL)


def _j_filters():
    f = j_build_filters(72, 45.0)
    mh, mv = jsct.band_matrices(f)
    return f, mh, mv


def test_strip_scielab_matches_jax(group):
    n, results = group
    f, mh, mv = _j_filters()
    spec = P(J_PIXEL, None, None)
    want = _jax_sm(n, lambda im: j_strip_scielab(im, mh, mv, f.half_width, WP), (spec,), spec,
                   jnp.asarray(w.row_image()))
    np.testing.assert_allclose(_rows_of(results, "scielab", 0), np.asarray(want), rtol=0, atol=LAB_ATOL)


def _j_strip_fitness(n, image, h_valid=None):
    """JAX's make_strip_fitness under shard_map, palette by palette."""
    f, mh, mv = _j_filters()
    cfg = JConfig(swasa=JSWASA(num_colors=5, population=3))
    hv = None if h_valid is None else jnp.int32(h_valid)

    def body(img, pal):
        target = j_strip_scielab(img, mh, mv, f.half_width, WP)
        return j_strip_fitness(img, target, mh, mv, f.half_width, WP, cfg, h_valid=hv)(pal)

    fn = jax.jit(shard_map(body, mesh=j_make_mesh(1, n), in_specs=(P(J_PIXEL, None, None), P()),
                           out_specs=(P(), P())))
    outs = [fn(jnp.asarray(image), jnp.asarray(p)) for p in w.strip_palettes()]
    return np.stack([np.asarray(o[0]) for o in outs]), np.stack([np.asarray(o[1]) for o in outs])


def test_strip_fitness_matches_jax(group):
    n, results = group
    want_err, want_use = _j_strip_fitness(n, w.row_image())
    _same_on_every_rank([{"s": {k: r["rows"][k] for k in ("strip_err", "strip_use")}} for r in results], "s")
    got = results[0]["rows"]
    np.testing.assert_array_equal(got["strip_use"], want_use)
    assert not got["strip_use"][0, 4]
    np.testing.assert_allclose(got["strip_err"], want_err, rtol=0, atol=ERR_ATOL)


def test_strip_fitness_with_h_valid_matches_jax(group):
    n, results = group
    image = w.row_image(w.ODD_H)
    H_pad = JBatch(JConfig(), j_make_mesh(1, n))._row_plan(w.ODD_H)
    padded = np.pad(image, ((0, H_pad - w.ODD_H), (0, 0), (0, 0)), mode="symmetric")
    want_err, want_use = _j_strip_fitness(n, padded, h_valid=w.ODD_H)
    got = results[0]["rows"]
    _same_on_every_rank([{"s": {k: r["rows"][k] for k in ("hvalid_err", "hvalid_use")}} for r in results], "s")
    np.testing.assert_array_equal(got["hvalid_use"], want_use)
    np.testing.assert_allclose(got["hvalid_err"], want_err, rtol=0, atol=ERR_ATOL)


def test_column_fitness_matches_jax(group):
    """The column-sharded kernel fitness against JAX's make_fast_fitness
    under shard_map (its own padded plan, slab guards, interpret mode)."""
    n, results = group
    H, W = w.COL_HW
    filters = j_build_filters(72, 45.0)
    # batched (identical values to member-pipelined, tests/test_sharding.py:357-407): fewer
    # interpreted kernel calls
    cfg = JConfig(swasa=JSWASA(num_colors=6, population=3), use_pallas="on", precision="highest",
                  overlap_collectives=False)
    mesh = j_make_mesh(1, n)
    prepare, *_ = j_fast_fns(mesh, cfg, filters, interpret=True)
    ctx = prepare(jnp.asarray(w.col_image())[None])
    Hp, _, Ws, ok = j_fast.plan_fast(H, W, filters.half_width, n)
    assert ok
    mh, mv = jsct.band_matrices(filters)
    pals = jnp.asarray(w.col_palettes())

    def body(x4_local, tgt_local):
        fitness = j_fast.make_fast_fitness(
            x4_local[0], tgt_local[0], cfg, mh, mv, WP, H=H, W=W, Hp=Hp, Ws=Ws, n_pixel=n, interpret=True,
        )
        return fitness(pals)

    want_err, want_use = shard_map(
        body, mesh=mesh, in_specs=(P(J_DATA, None, J_PIXEL), P(J_DATA, None, None, J_PIXEL)),
        out_specs=(P(), P()), check_vma=False,
    )(ctx["x4"], ctx["targets"])
    _same_on_every_rank(results, "columns")
    got = results[0]["columns"]
    np.testing.assert_array_equal(got["col_use_True"], np.asarray(want_use))
    np.testing.assert_allclose(got["col_err_True"], np.asarray(want_err), rtol=0, atol=ERR_ATOL)


def test_pipelined_equals_batched(group):
    _, results = group
    got = results[0]["columns"]
    np.testing.assert_array_equal(got["col_err_True"], got["col_err_False"])
    np.testing.assert_array_equal(got["col_use_True"], got["col_use_False"])


@pytest.fixture(scope="module")
def one_device():
    """BatchQuantizer's run and error images of the engine inputs, and each
    image's HybridQuantizer.error_image of the same output."""
    cfg = w.engine_config()
    images = w.engine_images()
    bq = BatchQuantizer(cfg, device="cpu")
    out, info = bq.run(images, polish_iters=2)
    de = [HybridQuantizer(cfg, device="cpu").error_image(images[i], out[i]) for i in range(len(images))]
    return {"palettes": info["palettes"].numpy(), "anneal_palettes": info["state"].best_colors.numpy(),
            "best_errors": info["best_errors"], "out": out.numpy(),
            "de": np.array([float(d[0]) for d in de]), "viz": np.stack([d[1].numpy() for d in de])}


@pytest.mark.parametrize("engine", list(w.ENGINES))
def test_engine_ranks_agree(engine):
    _same_on_every_rank(_ranks(2), f"engine_{engine}")


@pytest.mark.parametrize("engine", list(w.ENGINES))
def test_engine_matches_one_device(engine, one_device):
    got = _ranks(2)[0][f"engine_{engine}"]
    np.testing.assert_allclose(got["anneal_palettes"], one_device["anneal_palettes"], rtol=0, atol=ENGINE_ATOL)
    np.testing.assert_allclose(got["best_errors"], one_device["best_errors"], rtol=0, atol=ENGINE_ATOL)
    np.testing.assert_allclose(got["palettes"], one_device["palettes"], rtol=0, atol=ENGINE_ATOL)
    assert got["telemetry"].shape == (w.engine_config().swasa.imax, 2)
    assert got["out"].shape == w.engine_images().shape


@pytest.mark.parametrize("engine", list(w.ENGINES))
def test_engine_error_images_match_the_single_image_engine(engine, one_device):
    """error_images of the engine's own output against HybridQuantizer's."""
    got = _ranks(2)[0][f"engine_{engine}"]
    cfg = w.engine_config()
    images = w.engine_images()
    for i in range(len(images)):
        mean, viz = HybridQuantizer(cfg, device="cpu").error_image(images[i], got["out"][i])
        assert got["de"][i] == pytest.approx(float(mean), rel=DE_RTOL)
        np.testing.assert_allclose(got["viz"][i], viz.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("strategy", ["rows", "columns"])
def test_pop_axis_is_bit_equal(strategy):
    """(1, 2, 2) against (1, 1, 2): the pop ranks' slices, gathered, must not
    change a bit (tests/test_sharding.py:454-503)."""
    base, pop = (_ranks(4)[0][f"{m}_{strategy}"] for m in ("base", "pop"))
    for k in base:
        np.testing.assert_array_equal(pop[k], base[k], err_msg=k)
    for r in _ranks(4)[1:]:
        for k, v in r[f"pop_{strategy}"].items():
            np.testing.assert_array_equal(v, pop[k], err_msg=k)


def test_indivisible_population_and_small_groups_raise():
    res = _ranks(4)[0]
    assert "population 3 not divisible by the pop mesh axis (2)" in res["indivisible"]
    assert res["too_few_ranks"] == "mesh 1x1x8 needs 8 ranks, have 4"


def test_one_pixel_shard_is_the_single_image_fitness():
    """At n_pixel = 1 the column engine runs mirror B2 with no collective:
    the one-device fitness, bit for bit."""
    cfg = w.engine_config()
    img = w.col_image()
    pals = torch.from_numpy(w.col_palettes()[:, :4])
    f = build_filters()
    ctx = shard_context(torch.from_numpy(img)[None], f, cfg, (0, img.shape[1]))
    err, use = make_fast_fitness(ctx, cfg, make_mesh(device="cpu"), H=img.shape[0], W=img.shape[1])(pals[None])
    want_err, want_use = make_population_fitness(_make_context(img, f, cfg, "cpu"), cfg)(pals)
    assert torch.equal(err[0], want_err) and torch.equal(use[0], want_use)


def test_one_rank_mesh_engine_equals_batch_quantizer(one_device):
    """Without a process group the mesh has one rank, and the engine is
    BatchQuantizer's, bit for bit (columns at one shard)."""
    from hybridquantization_tpu_torch.parallel import ShardedBatchQuantizer

    q = ShardedBatchQuantizer(w.engine_config(), make_mesh(device="cpu"))
    assert (q.n_data, q.n_pop, q.n_pixel) == (1, 1, 1)
    out, info = q.run(w.engine_images(), polish_iters=2)
    np.testing.assert_array_equal(info["palettes"].numpy(), one_device["palettes"])
    np.testing.assert_array_equal(info["best_errors"], one_device["best_errors"])
    np.testing.assert_array_equal(out.numpy(), one_device["out"])
