"""`tools.tpu_f32x3` (the TPU engine's f32x3 fitness emulated with
split_assign) against JAX's `assign_opp_pop(precision="f32x3")` and its
Pallas-branch population fitness, both in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import HybridQuantizer as JQuantizer
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import pallas_assign as pa
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import colorspace as cs
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import probe_kernels as pk
from hybridquantization_tpu_torch.ops.probe_kernels import split2
from hybridquantization_tpu_torch.pipeline import _make_batch_context, _make_context
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.tools import pack_pixels, tpu_f32x3

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

H, W, K, POP = 64, 80, 16, 4
BLOCK = 1024
# Two f32 sums of the same 12 exact bf16 products (the plain version's
# contraction order, XLA's dot) may order two entries differently only where
# their exact scores lie within this of each other, relative to max(1,
# |score|): 12 roundings of at most 2^-24 of a product up to 1.5 in sRGB.
NEAR_TIE_REL = 1e-6
# split_assign feeds the same fp32 B2 as the engine; JAX's Pallas branch
# runs its f32x3 banded conv (about 1e-5 relative, ops/fused_fitness.py:42-51)
FITNESS_RTOL = 2e-5
# the port's srgb_to_opp against JAX's on the same palette: f32 ulps
OPP_ATOL = 1e-7


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, 3), dtype=np.float32)
    pals = rng.random((POP, K, 3), dtype=np.float32)
    pals[:, 5] = pals[:, 2]  # duplicate entries: the first index must win
    pals[0, 9] = pals[0, 2]
    pals[3, 11] = img[7, 9]  # an entry on a pixel
    return img, pals


def _jax_assign(img, pals):
    """JAX's f32x3 Pallas assignment in interpret mode: (its packed operands
    x4 (4, P), c4, o4 (pop, 4, K), and its opp (pop, 3, P), counts (pop, K),
    idx (pop, P))."""
    P = H * W
    x4 = pa.pack_pixels(jnp.asarray(img.reshape(-1, 3)), BLOCK)
    c4, o4 = zip(*(pa.pack_palette(jnp.asarray(p), jcs.srgb_to_opp(jnp.asarray(p))) for p in pals))
    c4, o4 = jnp.stack(c4), jnp.stack(o4)  # K = 16: no padded entries
    opp, acc = pa.assign_opp_pop(x4, c4, o4, jnp.int32(P), block=BLOCK, interpret=True,
                                 precision="f32x3")
    counts = pa.usage_counts(acc, K)
    idx = np.stack([np.asarray(pa.assign_idx(x4, c4[p], block=BLOCK, interpret=True,
                                             precision="f32x3"))[0, :P] for p in range(POP)])
    packed = [torch.from_numpy(np.array(a)) for a in (x4[:, :P], c4, o4)]
    return packed, (np.asarray(opp)[:, :, :P], np.asarray(counts), idx)


def _near_ties(img, pals, idx):
    """(pop, P) bool: pixels where an entry unlike the winner scores within
    NEAR_TIE_REL of the best, in the exact (f64) sum of the split products."""
    x4 = pack_pixels(torch.from_numpy(img.reshape(-1, 3)))
    xh, xl = (t.double() for t in split2(x4))
    out = np.zeros(idx.shape, bool)
    for p in range(POP):
        feats = torch.from_numpy(pals[p])
        c4 = torch.cat([feats, -0.5 * (feats * feats).sum(-1, keepdim=True)], -1).T
        ch, cl = (t.double() for t in split2(c4))
        s = (ch.T @ xh + ch.T @ xl + cl.T @ xh).numpy()  # (K, P)
        best = s.max(0)
        unlike = np.any(pals[p][:, None, :] != pals[p][idx[p]][None], axis=-1)  # (K, P)
        close = (best[None] - s <= NEAR_TIE_REL * np.maximum(1.0, np.abs(best))[None]) & unlike
        out[p] = close.any(0)
    return out


def _check_against_jax(got, want, tie, opp_atol):
    opp, counts, idx = (t.numpy() for t in got)
    j_opp, j_counts, j_idx = want
    np.testing.assert_array_equal(idx[~tie], j_idx[~tie])
    # duplicates: no pixel takes the later copy
    for p, later in ((0, 5), (1, 5), (2, 5), (3, 5), (0, 9)):
        assert not np.any(idx[p] == later) and not np.any(j_idx[p] == later)
    same = idx == j_idx
    np.testing.assert_allclose(opp.transpose(0, 2, 1)[same], j_opp.transpose(0, 2, 1)[same],
                               rtol=0, atol=opp_atol)
    # a near tie that went the other way moves one pixel between two counts
    assert np.abs(counts - j_counts).sum() <= 2 * (~same).sum()
    return same.all()


def test_split_assignment_matches_jax_f32x3():
    """split_assign on JAX's own packed operands: the same indices outside
    the near-tie class, and where they agree the same colours bit for bit;
    then the emulation's own packing (`pack_palette`, the port's
    srgb_to_opp, whose colours may differ from JAX's by f32 ulps)."""
    img, pals = _inputs()
    (x4, c4, o4), want = _jax_assign(img, pals)
    tie = _near_ties(img, pals, want[2])
    assert tie.mean() < 1e-3
    got = pk.split_assign(x4, c4, o4, tie_mode="first", opp_parts=3, return_index=True)
    if _check_against_jax(got, want, tie, opp_atol=0.0):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    own = tpu_f32x3.split_assign_pop(pack_pixels(torch.from_numpy(img.reshape(-1, 3))),
                                     torch.from_numpy(pals), return_index=True)
    _check_against_jax(own, want, tie, opp_atol=OPP_ATOL)


def test_split_flips_against_fp32_b1():
    """The emulation is not B1: its assignment differs from the fp32 scan on
    some pixels (the TPU's f32x3 flips, 4.9e-3 to 8.3e-3 of pixels at the
    parity configurations)."""
    img, pals = _inputs()
    feats = torch.from_numpy(img.reshape(-1, 3))
    t_pals = torch.from_numpy(pals)
    _, _, idx = tpu_f32x3.split_assign_pop(pack_pixels(feats), t_pals, return_index=True)
    _, _, b1 = ak.assign_opp_usage_pop(feats, t_pals, cs.srgb_to_opp(t_pals), return_index=True)
    flips = (idx != b1).float().mean().item()
    assert 0 < flips < 0.05


def test_split_population_fitness_matches_jax_pallas_branch():
    img, pals = _inputs()
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=POP), use_pallas="on", precision="f32x3")
    jq = JQuantizer(jcfg)
    j_fit = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg,
                          jq.filters.half_width)
    j_err, j_use = j_fit(jnp.asarray(pals))

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP))
    fit = tpu_f32x3.make_split_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)
    err, use = fit(torch.from_numpy(pals))
    np.testing.assert_array_equal(use.numpy(), np.asarray(j_use))
    assert not use.numpy().all()  # the duplicates are unused: the penalty is in both
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=FITNESS_RTOL)


@pytest.mark.parametrize("bad", ["lab", "average", "batch"])
def test_split_fitness_refuses_what_it_does_not_emulate(bad):
    img, _ = _inputs()
    kw = {"lab": dict(assignment_space="lab"), "average": dict(tie_mode="average")}.get(bad, {})
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP), **kw)
    ctx = (_make_batch_context([img, img], build_filters(), cfg, "cpu") if bad == "batch"
           else _make_context(img, build_filters(), cfg, "cpu"))
    with pytest.raises(ValueError):
        tpu_f32x3.make_split_population_fitness(ctx, cfg)


def test_layer2_with_split_fitness_runs_fitness_parity_protocol(capsys):
    rc = tpu_f32x3.main(["--content", "natural", "--size", "96", "--colors", "16", "--palettes", "2",
                         "--cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "DETERMINISTIC PARITY: PASS" in out
    flips = float(out.split("assignment flips: max ")[1].split()[0])
    assert flips > 0


@pytest.mark.parametrize("fault", [None, "two-part gather", "moved count", "far winner"])
def test_smoke_split_check_catches_a_wrong_gather_or_count(fault):
    """chip_smoke's `_check_split_first` (its tpu_f32x3 phase) passes the
    plain version against itself and fails on one fault put in: colours
    gathered from two bf16 parts, one pixel moved between two counts, a
    winner whose score is not within the near-tie class of the best."""
    import chip_smoke

    img, pals = _inputs()
    x4 = pack_pixels(torch.from_numpy(img.reshape(-1, 3)))
    t_pals = torch.from_numpy(pals)
    c4, o4 = pk.pack_palette(t_pals, cs.srgb_to_opp(t_pals))
    want = pk.split_assign_reference(x4, c4, o4, return_index=True)
    got = [t.clone() for t in want]
    if fault == "two-part gather":
        got[0] = pk.split_assign_reference(x4, c4, o4, opp_parts=2)[0]
    elif fault == "moved count":
        got[1][0, 0] += 1
        got[1][0, 1] -= 1
    elif fault == "far winner":
        got[2][0, 0] = (got[2][0, 0] + 1) % K
    if fault is None:
        assert chip_smoke._check_split_first("plain", x4, c4, got, want) == (0, 0)
    else:
        with pytest.raises(RuntimeError):
            chip_smoke._check_split_first(fault, x4, c4, got, want)
