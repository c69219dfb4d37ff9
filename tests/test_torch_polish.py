"""The torch port's Lloyd polish (B3's plain version, `lloyd_step`,
`lloyd_polish`, `polish_palette`) and ordered dithering against the JAX
package: the Pallas B3 kernel runs as its own tests run it on the CPU
(interpret mode, "highest"), the Lloyd steps through `use_pallas=False`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import HybridQuantizer as JQuantizer
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import assign as jassign
from hybridquantization_tpu.ops import pallas_assign as pa
from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig
from hybridquantization_tpu_torch.ops import assign as tassign
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# Near ties are relative: LAB scores reach ~1e4, where one f32 ulp is ~1e-3,
# so two f32 computations of the same score may order entries differently
# when the top-2 gap is below ~1e-6 of the larger |score| (1e-6 absolute
# for sRGB, whose scores are O(1)).
NEAR_TIE_REL = 1e-6
PALETTE_ATOL = 1e-5  # Lloyd steps: f64 centroid sums here, f32 segment sums in JAX
PERTURB_ATOL = 1e-6  # dither: one f32 palette-spacing mean on each side
WP = np.asarray(jcs.WHITEPOINT_D65)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _near_tie(feats, pal):
    """(P,) bool: the top-2 scores f.c - |c|^2/2 (f64) lie within the relative class."""
    f = np.asarray(feats, np.float64)
    c = np.asarray(pal, np.float64)
    s = f @ c.T - 0.5 * np.sum(c * c, -1)
    if s.shape[1] == 1:
        return np.zeros(len(f), bool)
    top2 = np.sort(s, axis=-1)[:, -2:]
    scale = np.maximum(1.0, np.abs(top2).max(-1))
    return (top2[:, 1] - top2[:, 0]) <= NEAR_TIE_REL * scale


def _features(space, n=3000, seed=0):
    px = np.random.default_rng(seed).random((n, 3), dtype=np.float32)
    return px if space == "srgb" else np.array(jcs.srgb_to_lab(jnp.asarray(px), WP))


@pytest.mark.parametrize("K,space", [(1, "srgb"), (13, "srgb"), (13, "lab"), (64, "lab")])
def test_b3_plain_matches_pallas(K, space):
    feats = _features(space, seed=K)
    pal = _features(space, n=K, seed=K + 100)
    if K >= 3:
        pal[K - 1] = pal[1]  # an exact duplicate: the first index must win every tie
    want = np.asarray(
        pa.nearest_palette_pallas(jnp.asarray(feats), jnp.asarray(pal), interpret=True, precision="highest")
    )
    got = ak.assign_idx(_t(feats), _t(pal))
    assert got.dtype == torch.int32 and got.shape == (feats.shape[0],)
    got = got.numpy()
    ok = ~_near_tie(feats, pal)
    np.testing.assert_array_equal(got[ok], want[ok])
    if K >= 3:
        assert not (got == K - 1).any() and not (want == K - 1).any()
        np.testing.assert_array_equal(got == 1, want == 1)
    if space == "srgb":  # the plain scan agrees with the engine's own assignment
        np.testing.assert_array_equal(got, tassign.nearest_palette(_t(feats), _t(pal)).numpy())


def test_b3_nan_convention_and_lloyd_step_drops_minus_one():
    px = np.random.default_rng(1).random((500, 3), dtype=np.float32)
    pal = np.random.default_rng(2).random((6, 3), dtype=np.float32)
    pal[4] = np.nan
    # Pallas: a NaN score makes the pixel's max NaN, so every pixel gets K_pad
    j_idx = np.asarray(
        pa.nearest_palette_pallas(jnp.asarray(px), jnp.asarray(pal), interpret=True, precision="highest")
    )
    assert (j_idx >= 6).all()
    # the port: a NaN entry never wins; a pixel with no number among its scores gets -1
    px[7] = np.nan
    idx = ak.assign_idx(_t(px), _t(pal)).numpy()
    keep = np.array([0, 1, 2, 3, 5])
    want = keep[tassign.nearest_palette(_t(px), _t(pal[keep])).numpy()]
    assert idx[7] == -1
    np.testing.assert_array_equal(np.delete(idx, 7), np.delete(want, 7))
    # lloyd_step drops the -1 pixel from the sums and counts; the NaN entry keeps its value
    got = tassign.lloyd_step(_t(px), _t(pal)).numpy()
    ref = tassign.lloyd_step(_t(np.delete(px, 7, 0)), _t(pal[keep])).numpy()
    np.testing.assert_array_equal(got[keep], ref)
    assert np.isnan(got[4]).all()


def _polish_inputs(space, K=8, seed=3):
    img = natural_image(40, 48, seed=seed)
    pal = np.random.default_rng(seed).random((K, 3), dtype=np.float32)
    return img.reshape(-1, 3), pal


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_lloyd_step_and_polish_match_jax(space):
    px, pal = _polish_inputs(space)
    if space == "lab":
        px = np.asarray(jcs.srgb_to_lab(jnp.asarray(px), WP))
        pal = np.asarray(jcs.srgb_to_lab(jnp.asarray(pal), WP))
    want = np.asarray(jassign.lloyd_step(jnp.asarray(px), jnp.asarray(pal)))
    got = tassign.lloyd_step(_t(px), _t(pal))
    assert got.dtype == torch.float32
    scale = 1.0 if space == "srgb" else 100.0  # LAB values reach 100
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PALETTE_ATOL * scale)
    want = np.asarray(jassign.lloyd_polish(jnp.asarray(px), jnp.asarray(pal), 6))
    got = tassign.lloyd_polish(_t(px), _t(pal), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PALETTE_ATOL * scale)


@pytest.mark.parametrize("method", ["exact", "hist"])
@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_polish_palette_matches_jax(space, method):
    px, pal = _polish_inputs(space, seed=5)
    want = np.asarray(
        jassign.polish_palette(jnp.asarray(px), jnp.asarray(pal), space, WP, 5, method, use_pallas=False)
    )
    before = ak.assign_idx.launches
    got = tassign.polish_palette(_t(px), _t(pal), space, WP, 5, method)
    assert ak.assign_idx.launches == before  # on the CPU the plain version runs
    assert got.shape == (8, 3) and bool(((got >= 0) & (got <= 1)).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PALETTE_ATOL)


def test_polish_palette_auto_and_unknown_method():
    px, pal = _polish_inputs("srgb")
    exact = tassign.polish_palette(_t(px), _t(pal), "srgb", WP, 3, "exact")
    torch.testing.assert_close(tassign.polish_palette(_t(px), _t(pal), "srgb", WP, 3), exact)
    with pytest.raises(ValueError, match="polish method"):
        tassign.polish_palette(_t(px), _t(pal), "srgb", WP, 3, "fast")
    with pytest.raises(ValueError, match="assignment space"):
        tassign.polish_palette(_t(px), _t(pal), "xyz", WP, 3)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_bayer_matrix_is_bit_equal(order):
    got = tassign.bayer_matrix(order)
    assert got.dtype == torch.float32 and got.shape == (1 << order, 1 << order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jassign.bayer_matrix(order)))


@pytest.mark.parametrize("K,order", [(6, 3), (1, 2), (20, 4)])
def test_dither_perturbation_matches_jax(K, order):
    img = natural_image(21, 27, seed=K)
    pal = np.random.default_rng(K).random((K, 3), dtype=np.float32)
    perturbed = np.asarray(jassign.dither_perturbation(jnp.asarray(img), jnp.asarray(pal), 0.7, order))
    got = tassign.dither_perturbation(_t(img), _t(pal), 0.7, order).numpy()
    scale = max(1.0, np.abs(perturbed).max())  # K=1: the spacing is sqrt(1e9)
    np.testing.assert_allclose(got, perturbed, rtol=0, atol=PERTURB_ATOL * scale)
    want = np.asarray(jassign.quantize_image_dithered(jnp.asarray(img), jnp.asarray(pal), 0.7, order))
    got = tassign.quantize_image_dithered(_t(img), _t(pal), 0.7, order).numpy()
    ok = ~_near_tie(perturbed.reshape(-1, 3), pal)
    np.testing.assert_array_equal(got.reshape(-1, 3)[ok], want.reshape(-1, 3)[ok])


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_quantize_with_dither_matches_jax(space):
    img = natural_image(36, 44, seed=8)
    pal = np.random.default_rng(8).random((7, 3), dtype=np.float32)
    want = np.asarray(JQuantizer(JConfig(assignment_space=space)).quantize(img, pal, dither=0.5))
    got = HybridQuantizer(QuantizationConfig(assignment_space=space), device="cpu").quantize(
        img, pal, dither=0.5
    )
    perturbed = np.asarray(jassign.dither_perturbation(jnp.asarray(img), jnp.asarray(pal), 0.5))
    feats, pf = perturbed.reshape(-1, 3), pal
    if space == "lab":
        feats = np.asarray(jcs.srgb_to_lab(jnp.asarray(feats), WP))
        pf = np.asarray(jcs.srgb_to_lab(jnp.asarray(pal), WP))
    ok = ~_near_tie(feats, pf)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 3)[ok], want.reshape(-1, 3)[ok])
    assert ok.mean() > 0.99
    undithered = np.asarray(JQuantizer(JConfig(assignment_space=space)).quantize(img, pal))
    assert not np.array_equal(want, undithered)  # the dither moved some pixels


@pytest.mark.parametrize(
    "f,p,err",
    [
        ((10, 4), (5, 3), ValueError),
        ((10, 3), (0, 3), ValueError),
        ((10, 3), (2, 5, 3), ValueError),
    ],
)
def test_b3_wrapper_checks_shapes(f, p, err):
    with pytest.raises(err):
        ak.assign_idx(torch.zeros(f), torch.zeros(p))


def test_b3_wrapper_checks_dtype_and_cpu_uses_no_kernel():
    with pytest.raises(TypeError):
        ak.assign_idx(torch.rand(10, 3).double(), torch.rand(4, 3))
    before = ak.assign_idx.launches
    assert ak.assign_idx(torch.rand(10, 3), torch.rand(4, 3)).shape == (10,)
    assert ak.assign_idx.launches == before
