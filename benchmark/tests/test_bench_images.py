"""The device copy of the natural-image recipe, held to the program's
numpy original at a small size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import images
from hybridquantization_tpu_torch.synth import natural_image


def stats(img: np.ndarray) -> tuple:
    flat = img.reshape(-1, 3).astype(np.float64)
    corr = np.corrcoef(flat.T)
    return flat.min(), flat.max(), flat.mean(), flat.std(), corr[np.triu_indices(3, 1)]


@pytest.mark.parametrize("h,w", [(96, 128), (72, 160)])
def test_range_and_channel_correlation_match_synth(h, w):
    ours = [images.make_set([(h, w)], seed, "cpu")[0] for seed in range(6)]
    theirs = [natural_image(h, w, seed) for seed in range(6)]
    for img in ours:
        assert img.dtype == np.float32 and img.shape == (h, w, 3)
        assert 0.0 < img.min() and img.max() < 1.0
    a = np.array([np.r_[stats(i)[2:4], stats(i)[4]] for i in ours]).mean(0)
    b = np.array([np.r_[stats(i)[2:4], stats(i)[4]] for i in theirs]).mean(0)
    np.testing.assert_allclose(a[:2], b[:2], atol=0.03)   # mean, spread
    np.testing.assert_allclose(a[2:], b[2:], atol=0.06)   # inter-channel correlation
    assert (a[2:] > 0.7).all()                            # luminance-dominant


def test_a_frame_is_fixed_by_seed_and_index():
    one = images.make_set([(40, 56), (40, 56)], 2**31 + 17, "cpu")
    two = images.make_set([(40, 56), (40, 56)], 2**31 + 17, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    assert not np.array_equal(one[0], one[1])
    assert not np.array_equal(one[0], images.make_set([(40, 56)], 5, "cpu")[0])


def test_derived_seeds_take_any_whole_run_seed():
    seeds = {images.derived_seed(s, i, k) for s in (0, 1, 2**31 + 5, -3) for i in range(3) for k in (0, 1)}
    assert len(seeds) == 24
    assert all(0 <= s < 2**63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))
