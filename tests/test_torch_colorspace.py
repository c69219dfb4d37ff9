"""The torch port's colour math, separable filter and S-CIELAB transform
against the JAX package, on the same numpy inputs (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import conv as jconv
from hybridquantization_tpu.scielab import transform as jsct
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.ops import conv as tconv
from hybridquantization_tpu_torch.scielab import transform as tsct

# One intra-op thread, in every tests/test_torch_*.py file (pytest imports
# them all into each worker, so they must agree). With two, torch splits a
# (4096,) sqrt between the threads, and in about one process in forty the
# second thread's half of the first such call came back up to 2.9e-4
# relative off (torch 2.13 CPU; the same call again was exact), which failed
# test_delta_e_matches_jax[CIE76]. The tests hold the port's math to JAX,
# not torch's thread pool.
torch.set_num_threads(1)


RTOL, ATOL = 1e-5, 1e-4  # f32 math in both; LAB values span ~1e2


def _rgb(seed, n=4096):
    x = np.random.default_rng(seed).random((n, 3), dtype=np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.5, 1], [0.0031308, 0.2, 0.9],
             [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0.5]]
    return x


def _lab(seed, n=4096):
    rng = np.random.default_rng(seed)
    lab = np.stack(
        [rng.uniform(0, 100, n), rng.uniform(-90, 90, n), rng.uniform(-90, 90, n)], -1
    ).astype(np.float32)
    lab[:4, 1:] = 0.0  # achromatic: exercises the hue-zero branches
    return lab


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "name,make",
    [
        ("srgb_to_linear", _rgb),
        ("linear_to_srgb", _rgb),
        ("srgb_to_xyz", _rgb),
        ("xyz_to_srgb", _rgb),
        ("xyz_to_opp", _rgb),
        ("opp_to_xyz", _rgb),
        ("srgb_to_opp", _rgb),
        ("srgb_to_lab", _rgb),
        ("opp_to_lab", _rgb),
        ("xyz_to_lab", _rgb),
        ("lab_to_xyz", _lab),
        ("lab_to_srgb", _lab),
    ],
)
def test_transform_matches_jax(name, make):
    x = make(3)
    want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
    got = getattr(tcs, name)(_t(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wp", ["D65", "D50"])
def test_lab_whitepoints_match_jax(wp):
    x = _rgb(4)
    want = np.asarray(jcs.srgb_to_lab(jnp.asarray(x), jcs.WHITEPOINTS[wp]))
    got = tcs.srgb_to_lab(_t(x), tcs.WHITEPOINTS[wp]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tcs.WHITEPOINTS[wp], jcs.WHITEPOINTS[wp])


def test_constants_equal_jax():
    for name in ("M_SRGB2XYZ", "M_XYZ2SRGB", "M_XYZ2OPP", "M_OPP2XYZ", "M_RGB2OPP"):
        np.testing.assert_array_equal(getattr(tcs, name), getattr(jcs, name))
    assert tcs.LAB_DELTA3 == jcs.LAB_DELTA3 and tcs.LAB_KAPPA == jcs.LAB_KAPPA


@pytest.mark.parametrize("kind", ["CIE76", "CIE94", "CIEDE2000"])
def test_delta_e_matches_jax(kind):
    a, b = _lab(5), _lab(6)
    b[:64] = a[:64] + 0.01  # near-identical pairs
    want = np.asarray(jcs.DELTA_E_FNS[kind](jnp.asarray(a), jnp.asarray(b)))
    got = tcs.delta_e(_t(a), _t(b), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_delta_e2000_sharma_pairs():
    # Sharma, Wu & Dalal (2005) test data, as tests/test_colorspace.py uses
    cases = [
        ((50.0, 2.6772, -79.7751), (50.0, 0.0, -82.7485), 2.0425),
        ((50.0, 2.8361, -74.0200), (50.0, 0.0, -82.7485), 3.4412),
        ((60.2574, -34.0099, 36.2677), (60.4626, -34.1751, 39.4387), 1.2644),
        ((50.0, 2.5, 0.0), (73.0, 25.0, -18.0), 27.1492),
        ((50.0, 2.5, 0.0), (50.0, 3.2592, 0.3350), 1.0000),
    ]
    for lab1, lab2, want in cases:
        got = float(tcs.delta_e2000(torch.tensor(lab1), torch.tensor(lab2)))
        assert got == pytest.approx(want, abs=2e-3)


def test_delta_e_dispatch_rejects_unknown():
    with pytest.raises(ValueError):
        tcs.delta_e(torch.zeros(3), torch.zeros(3), "NOPE")


def test_mirror_index_is_half_sample_reflection():
    # OptimizedConvolution.cl:21-27: off < 0 -> -off-1, off >= n -> 2n-off-1
    got = tconv.mirror_index(5, 3).tolist()
    assert got == [2, 1, 0, 0, 1, 2, 3, 4, 4, 3, 2]
    with pytest.raises(ValueError):
        tconv.mirror_index(2, 3)


@pytest.mark.parametrize("axis", [1, 2])
def test_conv1d_symmetric_matches_jax(axis):
    rng = np.random.default_rng(7)
    x = rng.random((7, 37, 45), dtype=np.float32)
    k = rng.standard_normal((7, 21)).astype(np.float32)
    want = np.asarray(jconv.conv1d_symmetric(jnp.asarray(x), jnp.asarray(k), axis=axis))
    got = tconv.conv1d_symmetric(_t(x), _t(k), axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_stacked_kernels_match_jax():
    f = tsct.build_filters(72, 45.0)
    for vertical in (False, True):
        np.testing.assert_array_equal(
            tsct.stacked_kernels(f, vertical).numpy(),
            np.asarray(jsct.stacked_kernels(f, vertical)),
        )


@pytest.mark.parametrize("wp", ["D65", "D50"])
def test_srgb_to_scielab_matches_jax(wp):
    img = np.random.default_rng(8).random((40, 52, 3), dtype=np.float32)
    f = tsct.build_filters(72, 45.0)
    want = np.asarray(jsct.srgb_to_scielab(jnp.asarray(img), f, jcs.WHITEPOINTS[wp]))
    got = tsct.srgb_to_scielab(_t(img), f, tcs.WHITEPOINTS[wp]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
