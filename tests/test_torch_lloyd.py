"""B3's Lloyd-step mode and the batched seeding and polish built on it, on
the CPU: the batched plain version against one problem at a time, the
batched k-means seeding against the member-by-member loop it replaced, and
the batched Lloyd steps and bucket polish against the JAX package's vmaps
(`jax.vmap(ops.kmeans.lloyd_steps_weighted)`, `parallel/batch._polish_batch`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import kmeans as jk
from hybridquantization_tpu.parallel.batch import _polish_batch
from hybridquantization_tpu_torch import QuantizationConfig
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import kmeans as tk
from hybridquantization_tpu_torch.parallel import BatchQuantizer
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

LLOYD_ATOL = 1e-5    # a few weighted-mean steps, each side rounding in its own order (test_torch_kmeans.py)
PALETTE_ATOL = 1e-5  # Lloyd polish: f64 centroid sums here, f32 segment sums in JAX (test_torch_polish.py)
WP = np.asarray(jcs.WHITEPOINT_D65)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _problem_inputs(F, M, K, weighted, seed=0, P=700):
    """(features (F, P, 3), palettes (F, M, K, 3), weights (F, P) or None):
    duplicate palette entries, rows whose scores are all NaN, and an entry
    far from every row (so it gets none)."""
    rng = np.random.default_rng(seed)
    feats = rng.random((F, P, 3), dtype=np.float32)
    feats[:, 5] = np.nan  # every score NaN: index -1, dropped from the sums
    pals = rng.random((F, M, K, 3), dtype=np.float32)
    if K >= 3:
        pals[:, :, K - 1] = pals[:, :, 1]  # the first index wins every tie
        pals[:, :, 2] = 40.0               # nearest to no row: keeps its colour
    weights = rng.integers(0, 5, (F, P)).astype(np.float32) if weighted else None
    return _t(feats), _t(pals), None if weights is None else _t(weights)


@pytest.mark.parametrize("K", [1, 13, 64])
@pytest.mark.parametrize("F,M", [(1, 1), (1, 3), (3, 1), (2, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_batched_lloyd_step_reference_is_each_problem_on_its_own(F, M, K, weighted):
    feats, pals, weights = _problem_inputs(F, M, K, weighted, seed=F * 100 + M * 10 + K)
    got = ak.lloyd_step_reference(feats, pals, weights)
    assert got.shape == (F, M, K, 3) and got.dtype == torch.float32
    assert torch.equal(ak.lloyd_step(feats, pals, weights), got)  # the wrapper on the CPU
    for f in range(F):
        w = None if weights is None else weights[f]
        for m in range(M):
            idx = ak.assign_idx_reference(feats[f], pals[f, m])
            assert int(idx[5]) == -1
            want = ak.centroid_update(feats[f], idx, pals[f, m], w)
            assert torch.equal(got[f, m], want)
            one = ak.lloyd_step(feats[f], pals[f, m], w)  # the unbatched layout
            assert one.shape == (K, 3) and torch.equal(one, want)
            if K >= 3:
                assert not bool((idx == K - 1).any())
                assert torch.equal(got[f, m, K - 1], pals[f, m, K - 1])
                assert torch.equal(got[f, m, 2], pals[f, m, 2])
    idx = ak.assign_idx(feats, pals)
    assert idx.shape == (F, M, feats.shape[1]) and idx.dtype == torch.int32
    for f in range(F):
        for m in range(M):
            assert torch.equal(idx[f, m], ak.assign_idx_reference(feats[f], pals[f, m]))


def test_lloyd_step_checks_its_arguments():
    feats, pals, weights = _problem_inputs(2, 3, 5, True)
    with pytest.raises(ValueError, match="palettes"):
        ak.lloyd_step(feats, pals[0])
    with pytest.raises(ValueError, match="palettes"):
        ak.lloyd_step(feats, pals[:1])
    with pytest.raises(ValueError, match="weights"):
        ak.lloyd_step(feats, pals, weights[:, 1:])
    with pytest.raises(TypeError):
        ak.lloyd_step(feats, pals, weights.double())
    before = (ak.lloyd_step.launches, ak.lloyd_step.unfused_launches, ak.assign_idx.launches)
    ak.lloyd_step(feats, pals, weights)
    assert (ak.lloyd_step.launches, ak.lloyd_step.unfused_launches, ak.assign_idx.launches) == before


def test_lloyd_plan_depends_on_the_rows_alone():
    for P in (1, 1023, 1024, 1025, 32_768, 1 << 18, 921_600, 3840 * 2160):
        blocks, per_block = ak.lloyd_plan(P)
        span = per_block * ak.B3_TILE_ROWS
        assert blocks <= ak.LLOYD_MAX_BLOCKS
        assert blocks * span >= P and (blocks - 1) * span < P  # no block without rows
    assert ak.lloyd_plan(32_768) == (32, 1)
    assert ak.lloyd_plan(3840 * 2160) == (262, 31)  # 8100 tiles


def _member_by_member(generator, pixels, K, pop, bits=5, iters=25):
    """kmeans_init_palettes as it was written before its Lloyd steps were
    batched: each member draws its start, then runs its steps alone."""
    counts, centers = tk.color_histogram(pixels, bits)
    out = []
    for _ in range(pop):
        pal = centers[tk.weighted_start(generator, counts, K)]
        for _ in range(iters):
            pal = ak.centroid_update(centers, ak.assign_idx_reference(centers, pal), pal, counts)
        out.append(pal)
    return torch.stack(out)


@pytest.mark.parametrize("K,pop", [(6, 3), (16, 4)])
def test_batched_kmeans_init_equals_the_member_loop(K, pop):
    imgs = [torch.as_tensor(natural_image(30, 40, seed=s)).reshape(-1, 3) for s in (1, 2, 3)]
    got = tk.kmeans_init_palettes(torch.Generator().manual_seed(9), imgs[0], K, pop, iters=7)
    want = _member_by_member(torch.Generator().manual_seed(9), imgs[0], K, pop, iters=7)
    assert got.shape == (pop, K, 3) and torch.equal(got, want)
    # a bucket: one seeding, each image from its own generator
    seeds = (4, 11, 5)
    got = tk.kmeans_init_palettes(
        tuple(torch.Generator().manual_seed(s) for s in seeds), torch.stack(imgs), K, pop, iters=7
    )
    assert got.shape == (3, pop, K, 3)
    for i, s in enumerate(seeds):
        assert torch.equal(got[i], _member_by_member(torch.Generator().manual_seed(s), imgs[i], K, pop, iters=7))


def _pixels(seed, n=4000):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


@pytest.mark.parametrize("members", [False, True])
def test_batched_lloyd_steps_weighted_matches_jax_vmap(members):
    hists = [jk.color_histogram(jnp.asarray(_pixels(s)), 5) for s in (7, 8, 9)]
    counts = np.stack([np.asarray(c) for c, _ in hists])
    centers = np.stack([np.asarray(c) for _, c in hists])
    pals = np.random.default_rng(10).random((3, 2, 16, 3) if members else (3, 16, 3), dtype=np.float32)
    step = jax.vmap(jk.lloyd_steps_weighted, in_axes=(None, None, 0, None))  # members share bins
    if members:
        want = jax.vmap(lambda c, x, p: step(c, x, p, 6))(counts, centers, pals)
    else:
        want = jax.vmap(jk.lloyd_steps_weighted, in_axes=(0, 0, 0, None))(counts, centers, pals, 6)
    got = tk.lloyd_steps_weighted(_t(counts), _t(centers), _t(pals), 6)
    assert got.shape == pals.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LLOYD_ATOL)


@pytest.mark.parametrize("space", ["srgb", "lab"])
@pytest.mark.parametrize("method,size", [("exact", (40, 48)), ("hist", (1024, 1024))])
def test_bucket_polish_matches_jax_polish_batch(space, method, size):
    # polish_palette's "auto": the histogram from 2^20 pixels an image on
    imgs = np.stack([natural_image(*size, seed=s) for s in (21, 22)])
    assert (size[0] * size[1] >= 1 << 20) == (method == "hist")
    pals = np.random.default_rng(23).random((2, 8, 3), dtype=np.float32)
    want = np.asarray(_polish_batch(jnp.asarray(imgs), jnp.asarray(pals), jnp.asarray(WP), space, 5))
    bq = BatchQuantizer(QuantizationConfig(assignment_space=space), device="cpu")
    got = bq.polish(imgs, pals, 5)
    assert got.shape == (2, 8, 3) and bool(((got >= 0) & (got <= 1)).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PALETTE_ATOL)
    # each image's palette as its own polish gives it (HybridQuantizer.polish)
    for i in range(2):
        assert torch.equal(got[i], bq.engine.polish(imgs[i], pals[i], 5))
