"""The fast modes (`precision="bf16"`, `tie_mode="average"`, `--fast`) of the
port against the JAX package on the CPU.

JAX's bf16 is a `Precision.DEFAULT` dot, which the CPU backend computes in
full f32, so the Pallas kernels in interpret mode cannot show the TPU's bf16
here. These tests build the TPU's semantics explicitly instead: every
operand rounded to bf16, each product exact in f32, the products summed in
f32. For B1 the JAX kernel runs at "highest" on `pack_pixels`/`pack_palette`
outputs rounded to bf16 beforehand; for B2 an emulation is assembled from
the JAX package's banded convolutions with `_fused_kernel`'s rounding points
made explicit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import pallas_assign as pa
from hybridquantization_tpu.ops.band_conv import BLOCK, conv_h_valid, conv_v_valid, padded_plan
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu.scielab import transform as jsct
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch import io as tio
from hybridquantization_tpu_torch.cli import main
from hybridquantization_tpu_torch.config import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.pipeline import (
    HybridQuantizer,
    _make_context,
    make_fitness,
    make_population_fitness,
)
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

NEAR_TIE = 1e-5  # f32 top-2 score gap (f64) below which f32 rounding may flip the winner
OPP_ATOL = 1e-6  # B1 average: the tied colours summed in another order
# B2 bf16: the f32 intermediate is rounded to bf16 between the passes, and
# the two sides sum its taps in other orders, so a value on a rounding
# boundary may round the other way (one bf16 step, 2^-8 relative, in one
# tap of a few pixels); the LAB and Delta-E tails differ at f32 rounding.
B2_BF16_RTOL = 1e-4
ERR_ATOL = 2e-5  # population fitness, as tests/test_torch_fused_fitness.py


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(space, K, pop=3, seed=0):
    """(features (P, 3), palette features (pop, K, 3), opponent palettes)
    on a 48x64 natural frame; member 0 holds two exact duplicates of one
    entry that wins a pixel, member 1 one duplicate pair."""
    img = natural_image(48, 64, seed=seed).reshape(-1, 3)
    pals = np.random.default_rng(seed + 1).random((pop, K, 3), dtype=np.float32)
    pals[0, 2] = img[1000]
    pals[0, K - 1] = pals[0, 2]
    pals[0, K // 2] = pals[0, 2]
    pals[1, 3] = pals[1, 0]
    opps = np.asarray(jax.vmap(jcs.srgb_to_opp)(jnp.asarray(pals)))
    if space == "lab":
        img = np.asarray(jcs.srgb_to_lab(jnp.asarray(img)))
        pals = np.asarray(jax.vmap(jcs.srgb_to_lab)(jnp.asarray(pals)))
    return img, pals, opps


def _jax_b1(feats, pal_feats, opps, tie_mode, bf16):
    """JAX's B1 (interpret mode, "highest") on its packed operands, rounded
    to bf16 first when `bf16`: (opp (pop, 3, P), per-entry hits (pop, K))."""
    P, K = feats.shape[0], pal_feats.shape[1]
    blk = pa.pick_block(K)
    x4 = pa.pack_pixels(jnp.asarray(feats), blk)
    c4, o4 = jax.vmap(pa.pack_palette)(jnp.asarray(pal_feats), jnp.asarray(opps))
    if bf16:  # the bias row is formed from the unrounded palette, then rounded
        x4, c4 = jnp.asarray(_bf16(x4)), jnp.asarray(_bf16(c4))
    opp, usage = pa.assign_opp_pop(
        x4, c4, o4, jnp.int32(P), block=blk, interpret=True, precision="highest",
        tie_mode=tie_mode,
    )
    return np.asarray(opp)[:, :, :P], np.asarray(jnp.sum(usage, axis=2))[:, :K]


def _port_b1(feats, pal_feats, opps, **kw):
    opp, counts, idx = ak.assign_opp_usage_pop(
        _t(feats), _t(pal_feats), _t(opps), return_index=True, **kw
    )
    return opp.numpy(), counts.numpy(), idx.numpy()


def _hits(s):
    """(P, K) bool: the entries that reach each pixel's maximum score."""
    return s == s.max(-1, keepdims=True)


def _order_sensitive(feats, pal):
    """(P,) bool: the bf16 scores summed bias-first (the port's order) and
    bias-last (a dot's) give different hit sets. Products of two bf16 values
    are exact in f32, so only the order of the three f32 adds differs."""
    f, c = _bf16(feats), _bf16(pal)
    sq = pal * pal
    bias = _bf16(-0.5 * ((sq[:, 0] + sq[:, 1]) + sq[:, 2]))
    prods = [f[:, k : k + 1] * c[:, k] for k in range(3)]
    first = ((bias + prods[0]) + prods[1]) + prods[2]
    last = ((prods[0] + prods[1]) + prods[2]) + bias
    return (_hits(first) != _hits(last)).any(-1)


def _distinct_near_tie(feats, pal):
    """(P,) bool: f32 near ties among the palette's distinct entries (exact
    duplicates tie in every order)."""
    c = np.unique(pal.astype(np.float64), axis=0)
    s = feats.astype(np.float64) @ c.T - 0.5 * np.sum(c * c, -1)
    top2 = np.sort(s, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) <= NEAR_TIE


@pytest.mark.parametrize("K", [6, 16])
def test_b1_average_matches_pallas(K):
    feats, pals, opps = _inputs("srgb", K, seed=K)
    j_opp, j_hits = _jax_b1(feats, pals, opps, "average", bf16=False)
    opp, counts, idx = _port_b1(feats, pals, opps, tie_mode="average")
    np.testing.assert_array_equal(counts > 0, j_hits > 0)
    assert counts[0, 2] == counts[0, K - 1] == counts[0, K // 2] > 0  # every tied entry is hit
    assert counts.sum(-1).min() >= feats.shape[0]  # hits, not pixels
    for p in range(len(pals)):
        ok = ~_distinct_near_tie(feats, pals[p])
        np.testing.assert_allclose(opp[p][:, ok], j_opp[p][:, ok], rtol=0, atol=OPP_ATOL)
        np.testing.assert_array_equal(counts[p], j_hits[p])
    # the tied entries' colour is their mean: here the duplicates' own colour
    tied = idx[0] == 2
    np.testing.assert_allclose(opp[0][:, tied], np.repeat(opps[0, 2][:, None], tied.sum(), 1), atol=OPP_ATOL)


@pytest.mark.parametrize("space", ["srgb", "lab"])
@pytest.mark.parametrize("tie_mode", ["first", "average"])
def test_b1_bf16_matches_tpu_semantics(space, tie_mode):
    K = 16
    feats, pals, opps = _inputs(space, K, seed=3)
    j_opp, j_hits = _jax_b1(feats, pals, opps, tie_mode, bf16=True)
    opp, counts, _ = _port_b1(feats, pals, opps, precision="bf16", tie_mode=tie_mode)
    # JAX's dot may sum the four products in another order; a pixel would be
    # excused where the two orders' hit sets differ. On these inputs none is.
    excused = np.stack([_order_sensitive(feats, p) for p in pals])
    assert int(excused.sum()) == 0
    np.testing.assert_allclose(opp, j_opp, rtol=0, atol=OPP_ATOL)
    np.testing.assert_array_equal(counts, j_hits)
    # bf16 moves winners: the rounding is not a no-op on this frame
    f32_opp, _, _ = _port_b1(feats, pals, opps, tie_mode=tie_mode)
    assert not np.array_equal(f32_opp, opp)


def test_b1_bf16_bias_is_rounded_from_the_unrounded_palette():
    """The bias -|c|^2/2 is formed in f32 from the unrounded palette and then
    rounded, as pack_palette does before the DEFAULT dot."""
    pal = np.array([[0.1, 0.7, 0.3], [0.4, 0.5, 0.9], [0.123, 0.456, 0.789]], np.float32)
    feats = np.random.default_rng(4).random((50, 3), dtype=np.float32)
    got = ak.scores(_t(feats), _t(pal), "bf16").numpy()
    c4, _ = pa.pack_palette(jnp.asarray(pal), jnp.asarray(pal))
    c4 = _bf16(c4)[:, :3]
    want = ((c4[3] + _bf16(feats)[:, :1] * c4[0]) + _bf16(feats)[:, 1:2] * c4[1]) + _bf16(feats)[:, 2:3] * c4[2]
    np.testing.assert_array_equal(got, want)


def _b2_emulation(q, target_planar, H, W, filters, kind, wp):
    """TPU bf16 B2 sums from the JAX package's pieces: the XLA banded
    convolutions of `pipeline.py:264-273` on a mirror-padded image, with the
    bf16 roundings of `_fused_kernel` at each pass's loads (the q values and
    horizontal band matrices; the f32 intermediate and vertical matrices)."""
    Hp, Wp, ok = padded_plan(H, W, filters.half_width)
    assert ok
    qp = np.pad(q, ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W)), mode="symmetric")
    q2 = np.pad(qp, ((0, 0), (0, 0), (BLOCK, BLOCK), (BLOCK, BLOCK)), mode="symmetric")
    mats_h, mats_v = jsct.band_matrices(filters)
    r = lambda m: tuple(jnp.asarray(_bf16(a)) for a in m)  # noqa: E731
    t7 = conv_h_valid(jnp.asarray(_bf16(q2)), r(mats_h), src=(0, 1, 2, 0, 1, 2, 0))
    y7 = conv_v_valid(jnp.asarray(_bf16(t7)), r(mats_v))
    y3 = y7[:, :3] + y7[:, 3:6]
    y3 = y3.at[:, 0].add(y7[:, 6])
    lab = jcs.opp_to_lab(jnp.moveaxis(y3[:, :, :H, :W], 1, -1), wp)
    de = jcs.DELTA_E_FNS[kind](jnp.moveaxis(jnp.asarray(target_planar), 0, -1), lab)
    return np.asarray(jnp.sum(de, axis=(1, 2)))


@pytest.mark.parametrize("kind", ["CIE76", "CIEDE2000"])
def test_b2_bf16_matches_tpu_emulation(kind):
    H, W = 70, 90
    img = natural_image(H, W, seed=5)
    pals = np.random.default_rng(6).random((2, 8, 3), dtype=np.float32)
    opp, _ = ak.assign_opp_usage_pop(_t(img.reshape(-1, 3)), _t(pals), tcs.srgb_to_opp(_t(pals)))
    q = opp.reshape(2, 3, H, W).numpy()
    f = build_filters()
    target = _make_context(img, f, QuantizationConfig(), "cpu")["target_planar"]
    kh, kv = stacked_kernels(f, False), stacked_kernels(f, True)
    wp = tcs.WHITEPOINTS["D65"]
    got = ff.fused_scielab_err_sums(_t(q), target, kh, kv, wp, kind, precision="bf16").numpy()
    want = _b2_emulation(q, target.numpy(), H, W, f, kind, jcs.WHITEPOINTS["D65"])
    np.testing.assert_allclose(got, want, rtol=B2_BF16_RTOL)
    exact = ff.fused_scielab_err_sums(_t(q), target, kh, kv, wp, kind).numpy()
    assert not np.array_equal(got, exact)


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_population_fitness_average_matches_jax(space):
    H, W, K, pop = 60, 72, 8, 3
    img = natural_image(H, W, seed=7)
    pals = np.random.default_rng(8).random((pop, K, 3), dtype=np.float32)
    pals[0, 1] = img[30, 40]  # wins at least that pixel
    pals[0, 5] = pals[0, 1]
    jcfg = JConfig(
        swasa=JSWASA(num_colors=K, population=pop), use_pallas="on", assignment_space=space,
        precision="highest", tie_mode="average",
    )
    jq = JQuantizer(jcfg)
    jctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    j_err, j_use = jax.jit(j_pop_fitness(jctx, jcfg, jq.filters.half_width))(jnp.asarray(pals))
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=pop), assignment_space=space, tie_mode="average"
    )
    err, use = make_population_fitness(_make_context(img, build_filters(), cfg, "cpu"), cfg)(_t(pals))
    np.testing.assert_array_equal(use.numpy(), np.asarray(j_use))
    assert use[0, 1] and use[0, 5]  # both duplicates are used in average mode
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=0, atol=ERR_ATOL)


def test_population_fitness_passes_each_precision_on():
    """B1 takes cfg.precision and cfg.tie_mode; B2 cfg.conv_precision, or
    cfg.precision when that is empty."""
    H, W, K = 40, 52, 6
    img = natural_image(H, W, seed=9)
    pals = _t(np.random.default_rng(10).random((2, K, 3), dtype=np.float32))
    f = build_filters()

    def run(**kw):
        cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=2), **kw)
        return make_population_fitness(_make_context(img, f, cfg, "cpu"), cfg)(pals)[0]

    ctx = _make_context(img, f, QuantizationConfig(), "cpu")
    feats = ctx["assign_pixels"]
    opps = tcs.srgb_to_opp(pals)

    def manual(precision, tie_mode, conv_precision):
        opp, counts = ak.assign_opp_usage_pop(feats, pals, opps, precision=precision, tie_mode=tie_mode)
        sums = ff.fused_scielab_err_sums(
            opp.reshape(2, 3, H, W), ctx["target_planar"], ctx["kh"], ctx["kv"],
            ctx["whitepoint"], precision=conv_precision,
        )
        return sums / (H * W) + 2.0 * (counts == 0).sum(-1).float()

    torch.testing.assert_close(run(precision="bf16"), manual("bf16", "first", "bf16"), rtol=0, atol=0)
    torch.testing.assert_close(
        run(precision="bf16", conv_precision="highest"), manual("bf16", "first", "highest"), rtol=0, atol=0
    )
    torch.testing.assert_close(
        run(conv_precision="bf16", tie_mode="average"), manual("f32x3", "average", "bf16"), rtol=0, atol=0
    )
    assert not torch.equal(run(precision="bf16"), run())


def test_make_fitness_scores_at_the_configured_precision():
    img = natural_image(40, 52, seed=11)
    pal = _t(np.random.default_rng(12).random((6, 3), dtype=np.float32))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=6), precision="bf16")
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    _, usage = make_fitness(ctx, cfg)(pal)
    idx = ak.nearest_scan(ctx["assign_pixels"], pal, "bf16")
    np.testing.assert_array_equal(usage.numpy(), np.bincount(idx.numpy(), minlength=6) > 0)
    # first-index ties and an fp32 filter: the single-palette fitness is B1's
    # bf16 "first" followed by B2 in fp32
    pop_cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=6), precision="bf16", conv_precision="highest")
    err, use = make_population_fitness(ctx, pop_cfg)(pal[None])
    e, u = make_fitness(ctx, cfg)(pal)
    assert torch.equal(u, use[0]) and float(e) == pytest.approx(float(err[0]), rel=1e-5)


@pytest.mark.parametrize(
    "flags",
    [["--fast"], ["--precision", "bf16", "--tie-mode", "average", "--conv-precision", "highest"]],
)
def test_quantize_fast_runs_through_the_cli(tmp_path, capsys, flags):
    src, dst = tmp_path / "in.ppm", tmp_path / "out.ppm"
    tio.save_image(str(src), natural_image(36, 44, seed=13))
    argv = ["quantize", str(src), str(dst), "-k", "5", "--imax", "6", "--init", "kmeans", "--polish", "2"]
    assert main(argv + flags, device="cpu") == 0
    assert "final error" in capsys.readouterr().out
    out = tio.load_image(str(dst))
    assert out.shape == (36, 44, 3) and len(np.unique(out.reshape(-1, 3), axis=0)) <= 5


def test_fast_engine_runs_and_repeats():
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=5, population=3, imax=8), precision="bf16", tie_mode="average"
    )
    img = natural_image(30, 34, seed=14)
    q = HybridQuantizer(cfg, device="cpu")
    a, info = q.find_palette(img)
    b, _ = q.find_palette(img)
    assert torch.equal(a, b) and np.all(np.diff(info["telemetry"]["best_error"]) <= 0)
