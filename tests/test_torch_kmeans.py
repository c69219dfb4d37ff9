"""The torch port's k-means seeding (`ops/kmeans.py`) against the JAX
package's `ops/kmeans.py`, on inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu.ops import kmeans as jk
from hybridquantization_tpu_torch.ops import kmeans as tk

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

CENTER_ATOL = 1e-6  # bin means: f64 sums cast to f32 here, f32 segment sums there
LLOYD_ATOL = 1e-5   # a few weighted-mean steps, each side rounding in its own order


def _t(x):
    return torch.from_numpy(np.array(x))


def _pixels(seed, n=4000):
    px = np.random.default_rng(seed).random((n, 3), dtype=np.float32)
    # the edges of the clip: exactly 0 and 1, and values outside [0, 1]
    px[:6] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [-0.01, 0.2, 1.02], [0.999, 0.5, 0.0], [0.5, 1.5, -2]]
    return px


@pytest.mark.parametrize("bits", [5, 6])
def test_color_histogram_matches_jax(bits):
    px = _pixels(bits)
    j_counts, j_centers = jk.color_histogram(jnp.asarray(px), bits)
    counts, centers = tk.color_histogram(_t(px), bits)
    assert counts.shape == (1 << (3 * bits),) and counts.dtype == torch.float32
    assert centers.shape == (1 << (3 * bits), 3) and centers.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(centers.numpy(), np.asarray(j_centers), rtol=0, atol=CENTER_ATOL)


def test_lloyd_steps_weighted_matches_jax():
    counts, centers = jk.color_histogram(jnp.asarray(_pixels(7)), 5)
    pal = np.random.default_rng(8).random((16, 3), dtype=np.float32)
    want = jk.lloyd_steps_weighted(counts, centers, jnp.asarray(pal), 6)
    got = tk.lloyd_steps_weighted(
        _t(np.asarray(counts)), _t(np.asarray(centers)), _t(pal), 6
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LLOYD_ATOL)


def _sorted_rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


def test_fewer_occupied_bins_than_k_seed_the_lowest_empty_bins():
    # five colors in five distinct bins, none of them bins 0-2
    colors = np.array(
        [[0.9, 0.1, 0.1], [0.1, 0.8, 0.2], [0.3, 0.3, 0.9], [0.7, 0.7, 0.2], [0.5, 0.5, 0.5]],
        np.float32,
    )
    px = colors[np.random.default_rng(9).integers(0, 5, 600)]
    j_counts, j_centers = jk.color_histogram(jnp.asarray(px), 5)
    want = jk.weighted_kmeans(jax.random.PRNGKey(4), j_counts, j_centers, 8, 25)
    counts, centers = tk.color_histogram(_t(px), 5)
    got = tk.weighted_kmeans(torch.Generator().manual_seed(4), counts, centers, 8, 25)
    # JAX sums ~120 copies of a color per bin in f32: its means round by ~1e-6
    np.testing.assert_allclose(_sorted_rows(got), _sorted_rows(want), rtol=0, atol=LLOYD_ATOL)
    grid0 = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 1.5], [0.5, 0.5, 2.5]], np.float32) / 32
    np.testing.assert_allclose(_sorted_rows(got)[:3], grid0, rtol=0, atol=CENTER_ATOL)


def test_weighted_start_draws_distinct_occupied_bins():
    counts = torch.zeros(64)
    counts[[3, 10, 11, 40, 63]] = torch.tensor([5.0, 1.0, 2.0, 7.0, 1.0])
    start = tk.weighted_start(torch.Generator().manual_seed(0), counts, 5)
    assert sorted(start.tolist()) == [3, 10, 11, 40, 63]
    start = tk.weighted_start(torch.Generator().manual_seed(0), counts, 7)
    assert sorted(start[:5].tolist()) == [3, 10, 11, 40, 63] and start[5:].tolist() == [0, 1]
    with pytest.raises(ValueError, match="larger sample"):
        tk.weighted_start(torch.Generator(), counts, 65)


def test_kmeans_init_palettes_shape_range_and_determinism():
    px = _t(np.clip(_pixels(11, 3000), 0, 1))
    a = tk.kmeans_init_palettes(torch.Generator().manual_seed(5), px, 12, 3)
    b = tk.kmeans_init_palettes(torch.Generator().manual_seed(5), px, 12, 3)
    c = tk.kmeans_init_palettes(torch.Generator().manual_seed(6), px, 12, 3)
    assert a.shape == (3, 12, 3) and a.dtype == torch.float32
    assert bool(((a >= 0) & (a <= 1)).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # each member from its own start
