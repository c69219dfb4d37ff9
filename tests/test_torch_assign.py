"""The torch port's assignment (plain path and the B1 kernel's plain
version) against the JAX package: `ops.assign` and the Pallas population
kernel run as its own tests run it on the CPU (interpret mode, "highest")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import assign as jassign
from hybridquantization_tpu.ops import pallas_assign as pa
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.ops import assign as tassign
from hybridquantization_tpu_torch.ops import assign_kernel as ak

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

NEAR_TIE = 1e-5  # top-2 score gap (f64) below which f32 rounding may flip the winner


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _near_tie(feats, pal):
    """(P,) bool: the two best scores f.c - |c|^2/2 (in f64) lie within NEAR_TIE."""
    f = feats.astype(np.float64)
    c = pal.astype(np.float64)
    s = f @ c.T - 0.5 * np.sum(c * c, -1)
    top2 = np.sort(s, axis=-1)[:, -2:] if s.shape[1] > 1 else np.concatenate([s, s - 1], 1)
    return (top2[:, 1] - top2[:, 0]) <= NEAR_TIE


def _image_feats(seed, h=100, w=130):
    return np.random.default_rng(seed).random((h * w, 3), dtype=np.float32)


@pytest.mark.parametrize("K", [6, 33, 300])
def test_nearest_palette_matches_jax(K):
    feats = _image_feats(K)
    pal = np.random.default_rng(K + 1).random((K, 3), dtype=np.float32)
    want = np.asarray(jassign.nearest_palette(jnp.asarray(feats), jnp.asarray(pal)))
    got = tassign.nearest_palette(_t(feats), _t(pal)).numpy()
    ok = ~_near_tie(feats, pal)
    np.testing.assert_array_equal(got[ok], want[ok])
    # the plain scan's blocks (13000 pixels in blocks of 4096) change nothing
    blocked = ak.assign_idx_reference(_t(feats), _t(pal), block_size=4096).numpy()
    np.testing.assert_array_equal(blocked, got)


def test_palette_usage_and_quantize_image_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((30, 41, 3), dtype=np.float32)
    pal = rng.random((9, 3), dtype=np.float32)
    idx = rng.integers(0, 9, 50).astype(np.int64)
    idx[idx == 4] = 0  # entry 4 unused
    np.testing.assert_array_equal(
        tassign.palette_usage(_t(idx), 9).numpy(),
        np.asarray(jassign.palette_usage(jnp.asarray(idx), 9)),
    )
    np.testing.assert_array_equal(
        tassign.quantize_image(_t(img), _t(pal)).numpy(),
        np.asarray(jassign.quantize_image(jnp.asarray(img), jnp.asarray(pal))),
    )


def _jax_b1(feats, pals):
    """JAX Pallas B1 in interpret mode: (opp (pop,3,P), usage (pop,K), idx (pop,P))."""
    opps = jax.vmap(jcs.srgb_to_opp)(jnp.asarray(pals))
    opp, usage = pa.assign_opp_usage_pop(
        jnp.asarray(feats), jnp.asarray(pals), opps, interpret=True, precision="highest"
    )
    idx = np.stack(
        [
            np.asarray(
                pa.nearest_palette_pallas(
                    jnp.asarray(feats), jnp.asarray(p), interpret=True, precision="highest"
                )
            )
            for p in pals
        ]
    )
    return np.asarray(opp), np.asarray(usage), idx, np.asarray(opps)


@pytest.mark.parametrize("K", [6, 33])
def test_b1_plain_matches_pallas(K):
    pop = 3
    feats = _image_feats(10 + K)
    pals = np.random.default_rng(20 + K).random((pop, K, 3), dtype=np.float32)
    j_opp, j_usage, j_idx, j_opps = _jax_b1(feats, pals)

    opps = tcs.srgb_to_opp(_t(pals))
    opp, counts, idx = ak.assign_opp_usage_pop(_t(feats), _t(pals), opps, return_index=True)
    opp, counts, idx, opps = opp.numpy(), counts.numpy(), idx.numpy(), opps.numpy()
    assert opp.shape == (pop, 3, feats.shape[0]) and opp.dtype == np.float32
    assert counts.dtype == np.int32 and idx.dtype == np.int32
    np.testing.assert_array_equal(counts > 0, j_usage)
    np.testing.assert_array_equal(counts.sum(1), np.full(pop, feats.shape[0]))
    for p in range(pop):
        ok = ~_near_tie(feats, pals[p])
        np.testing.assert_array_equal(idx[p][ok], j_idx[p][ok])
        np.testing.assert_array_equal(counts[p], np.bincount(idx[p], minlength=K))
        same = idx[p] == j_idx[p]
        np.testing.assert_allclose(opp[p][:, same], j_opp[p][:, same], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(opp[p], opps[p][idx[p]].T)


def test_b1_duplicate_entries_resolve_to_first_index():
    feats = _image_feats(30, 40, 50)
    pal = np.random.default_rng(31).random((8, 3), dtype=np.float32)
    pal[5] = pal[2]  # exact duplicate: every score ties
    pal[7] = pal[2]
    pals = pal[None]
    _, j_usage, j_idx, _ = _jax_b1(feats, pals)
    opp, counts, idx = ak.assign_opp_usage_pop(
        _t(feats), _t(pals), tcs.srgb_to_opp(_t(pals)), return_index=True
    )
    counts, idx = counts.numpy()[0], idx.numpy()[0]
    assert counts[2] > 0 and counts[5] == 0 and counts[7] == 0
    assert not j_usage[0, 5] and not j_usage[0, 7]
    np.testing.assert_array_equal((counts > 0), j_usage[0])
    assert not np.isin(idx, [5, 7]).any() and not np.isin(j_idx[0], [5, 7]).any()


def test_b1_nan_entry_never_wins():
    feats = _image_feats(40, 40, 50)
    pal = np.random.default_rng(41).random((6, 3), dtype=np.float32)
    pal[3] = np.nan
    pals = pal[None]
    _, j_usage, _, _ = _jax_b1(feats, pals)
    assert not j_usage[0, 3]
    opp, counts, idx = ak.assign_opp_usage_pop(
        _t(feats), _t(pals), tcs.srgb_to_opp(_t(pals)), return_index=True
    )
    counts, idx = counts.numpy()[0], idx.numpy()[0]
    assert counts[3] == 0 and counts.sum() == feats.shape[0]
    # the rest compete as if the NaN entry were not there
    keep = np.array([0, 1, 2, 4, 5])
    want = keep[tassign.nearest_palette(_t(feats), _t(pal[keep])).numpy()]
    np.testing.assert_array_equal(idx, want)
    assert np.isfinite(opp.numpy()).all()


def test_b1_all_nan_pixel_has_no_winner():
    feats = _image_feats(50, 4, 5)
    feats[3] = np.nan
    pals = np.random.default_rng(51).random((2, 4, 3), dtype=np.float32)
    opp, counts, idx = ak.assign_opp_usage_pop(
        _t(feats), _t(pals), tcs.srgb_to_opp(_t(pals)), return_index=True
    )
    assert (idx[:, 3] == -1).all() and (opp[:, :, 3] == 0).all()
    assert (counts.sum(1) == feats.shape[0] - 1).all()


@pytest.mark.parametrize(
    "shapes,err",
    [
        (((10, 4), (2, 5, 3), (2, 5, 3)), ValueError),
        (((10, 3), (5, 3), (5, 3)), ValueError),
        (((10, 3), (2, 5, 3), (2, 6, 3)), ValueError),
    ],
)
def test_b1_wrapper_checks_shapes(shapes, err):
    a, b, c = (torch.zeros(s) for s in shapes)
    with pytest.raises(err):
        ak.assign_opp_usage_pop(a, b, c)


def test_b1_wrapper_checks_dtype_and_cpu_uses_no_kernel():
    f = torch.rand(10, 3)
    p = torch.rand(2, 4, 3)
    with pytest.raises(TypeError):
        ak.assign_opp_usage_pop(f.double(), p, p)
    before = ak.assign_opp_usage_pop.launches
    ak.assign_opp_usage_pop(f, p, p)
    assert ak.assign_opp_usage_pop.launches == before  # the plain version ran
