"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test takes the `cuda_device` fixture, which skips when
no CUDA device is present, so every worker collects the same tests. This
file imports only torch, numpy and the port, so it also runs on a machine
without jax: `python -m pytest tests/test_torch_cuda.py -q --noconftest`
(tests/conftest.py imports jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch import colorspace as cs
from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.ops import assign as assign_ops
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.parallel import BatchQuantizer
from hybridquantization_tpu_torch.pipeline import (
    _make_batch_context,
    _make_context,
    make_population_fitness,
    setup_device,
)
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py
pytestmark = pytest.mark.cuda

NEAR_TIE = 1e-5  # |score gap| (f64) within which f32 rounding may pick either entry
# B3: near ties are relative, LAB scores reach ~1e4 where one f32 ulp is ~1e-3
NEAR_TIE_REL = 1e-6
SUM_RTOL = 1e-5  # B2: f32 filters in another FMA order; sums reduced in f64 vs f32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return setup_device("cuda")


def _rand(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(dev)


def _check_b1(feats, pals):
    opps = cs.srgb_to_opp(pals)
    before = ak.assign_opp_usage_pop.launches
    opp, counts, idx = ak.assign_opp_usage_pop(feats, pals, opps, return_index=True)
    torch.cuda.synchronize()
    assert ak.assign_opp_usage_pop.launches == before + 1
    p_opp, p_counts, p_idx = ak.assign_opp_usage_pop_reference(feats, pals, opps)
    pop, K, _ = pals.shape
    assert opp.shape == (pop, 3, feats.shape[0]) and counts.dtype == torch.int32
    assert bool((counts.sum(1) == feats.shape[0]).all())
    for p in range(pop):
        assert torch.equal(counts[p].long(), torch.bincount(idx[p].long(), minlength=K))
    diff = idx != p_idx
    if diff.any():
        m, i = torch.nonzero(diff, as_tuple=True)
        f = feats[i].double()
        ca, cb = pals[m, idx[m, i].long()].double(), pals[m, p_idx[m, i].long()].double()
        gap = (f * ca).sum(-1) - 0.5 * (ca * ca).sum(-1) - (f * cb).sum(-1) + 0.5 * (cb * cb).sum(-1)
        assert gap.abs().max().item() <= NEAR_TIE
    same = ~diff
    assert torch.equal(opp.transpose(1, 2)[same], p_opp.transpose(1, 2)[same])
    return opp, counts, idx


@pytest.mark.parametrize("K", [7, 256, 1500, 5000])
def test_b1_kernel_matches_plain(cuda_device, K):
    feats = _rand((173 * 301, 3), K, cuda_device)
    pals = _rand((3, K, 3), K + 1, cuda_device)
    _check_b1(feats, pals)


def test_b1_kernel_lab_features(cuda_device):
    img = torch.as_tensor(natural_image(120, 160, seed=3), device=cuda_device)
    feats = cs.srgb_to_lab(img.reshape(-1, 3)).contiguous()
    pals = cs.srgb_to_lab(_rand((2, 64, 3), 4, cuda_device)).contiguous()
    _check_b1(feats, pals)


def test_b1_kernel_ties_and_nan(cuda_device):
    feats = _rand((5000, 3), 5, cuda_device)
    feats[17] = float("nan")
    pal = _rand((9, 3), 6, cuda_device)
    pal[5] = pal[2]
    pal[8] = float("nan")
    opp, counts, idx = ak.assign_opp_usage_pop(
        feats, pal[None].contiguous(), cs.srgb_to_opp(pal)[None].contiguous(), return_index=True
    )
    assert counts[0, 5] == 0 and counts[0, 8] == 0 and counts[0, 2] > 0
    assert idx[0, 17] == -1 and bool((opp[0, :, 17] == 0).all())
    assert int(counts.sum()) == 4999
    keep = torch.tensor([0, 1, 2, 3, 4, 6, 7], device=cuda_device)
    want = keep[ak.assign_idx_reference(feats, pal[keep]).long()]
    ok = torch.arange(5000, device=cuda_device) != 17
    assert torch.equal(idx[0][ok].long(), want[ok])


def _check_b3(feats, pal):
    """B3 on the card against its plain version: indices equal outside the
    relative near-tie class (gap <= NEAR_TIE_REL * max(1, |score|))."""
    before = ak.assign_idx.launches
    idx = ak.assign_idx(feats, pal)
    torch.cuda.synchronize()
    assert ak.assign_idx.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (feats.shape[0],)
    want = ak.assign_idx_reference(feats, pal)
    diff = idx != want
    if diff.any():
        (i,) = torch.nonzero(diff, as_tuple=True)
        f = feats[i].double()
        ca, cb = pal[idx[i].long()].double(), pal[want[i].long()].double()
        sa = (f * ca).sum(-1) - 0.5 * (ca * ca).sum(-1)
        sb = (f * cb).sum(-1) - 0.5 * (cb * cb).sum(-1)
        scale = torch.maximum(sa.abs(), sb.abs()).clamp_min(1.0)
        assert bool(((sa - sb).abs() <= NEAR_TIE_REL * scale).all())
    return idx


@pytest.mark.parametrize("K", [1, 16, 256, 1025, 5000])
def test_b3_kernel_matches_plain(cuda_device, K):
    feats = _rand((173 * 301, 3), 40 + K, cuda_device)  # 52073 pixels: not a multiple of 512
    _check_b3(feats, _rand((K, 3), 41 + K, cuda_device))


def test_b3_kernel_lab_features(cuda_device):
    img = torch.as_tensor(natural_image(120, 160, seed=3), device=cuda_device)
    feats = cs.srgb_to_lab(img.reshape(-1, 3)).contiguous()
    _check_b3(feats, cs.srgb_to_lab(_rand((200, 3), 7, cuda_device)).contiguous())


def test_b3_kernel_ties_and_nan(cuda_device):
    feats = _rand((3001, 3), 8, cuda_device)
    feats[17] = float("nan")
    pal = _rand((9, 3), 9, cuda_device)
    pal[5] = pal[2]
    pal[8] = float("nan")
    idx = ak.assign_idx(feats, pal)
    assert int(idx[17]) == -1
    assert not bool(((idx == 5) | (idx == 8)).any()) and bool((idx == 2).any())
    keep = torch.tensor([0, 1, 2, 3, 4, 6, 7], device=cuda_device)
    want = keep[ak.assign_idx_reference(feats, pal[keep]).long()]
    ok = torch.arange(3001, device=cuda_device) != 17
    assert torch.equal(idx[ok].long(), want[ok])


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_lloyd_polish_on_the_card_matches_cpu(cuda_device, space):
    px = torch.as_tensor(natural_image(96, 128, seed=4)).reshape(-1, 3)
    pal = _rand((8, 3), 10, "cpu")
    before = ak.assign_idx.launches
    got = assign_ops.polish_palette(px.to(cuda_device), pal.to(cuda_device), space, cs.WHITEPOINT_D65, 10, "exact")
    torch.cuda.synchronize()
    assert ak.assign_idx.launches == before + 10
    want = assign_ops.polish_palette(px, pal, space, cs.WHITEPOINT_D65, 10, "exact")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["CIE76", "CIE94", "CIEDE2000"])
@pytest.mark.parametrize("H,W", [(211, 333), (11, 300), (64, 11)])
def test_b2_kernel_matches_plain(cuda_device, kind, H, W):
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    img = torch.as_tensor(natural_image(H, W, seed=1), device=cuda_device)
    target = torch.movedim(cs.srgb_to_lab(img), -1, 0).contiguous()
    q = cs.srgb_to_opp(torch.movedim(_rand((3, 3, H, W), 2, cuda_device), 1, -1))
    q = torch.movedim(q, -1, 1).contiguous()
    before = ff.fused_scielab_err_sums.launches
    got = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, kind)
    again = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, kind)
    torch.cuda.synchronize()
    assert ff.fused_scielab_err_sums.launches == before + 2
    assert torch.equal(got, again)  # fixed-order reduction: run-to-run identical
    want = ff.fused_scielab_err_sums_reference(q, target, kh, kv, cs.WHITEPOINT_D65, kind)
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)


def test_wrappers_reject_mixed_devices(cuda_device):
    with pytest.raises(ValueError):
        ak.assign_opp_usage_pop(
            torch.rand(10, 3, device=cuda_device), torch.rand(1, 4, 3), torch.rand(1, 4, 3)
        )
    kh = torch.rand(7, 21, device=cuda_device)
    with pytest.raises(ValueError):
        ff.fused_scielab_err_sums(
            torch.rand(1, 3, 30, 30, device=cuda_device), torch.rand(3, 30, 30), kh, kh,
            cs.WHITEPOINT_D65,
        )


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_population_fitness_on_the_card_matches_cpu(cuda_device, space):
    img = natural_image(96, 128, seed=2)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=16, population=4), assignment_space=space)
    pals = _rand((4, 16, 3), 9, "cpu")
    f = build_filters()
    e_gpu, u_gpu = make_population_fitness(_make_context(img, f, cfg, cuda_device), cfg)(
        pals.to(cuda_device)
    )
    e_cpu, u_cpu = make_population_fitness(_make_context(img, f, cfg, "cpu"), cfg)(pals)
    assert torch.equal(u_gpu.cpu(), u_cpu)
    torch.testing.assert_close(e_gpu.cpu(), e_cpu, rtol=0, atol=2e-5)


def test_engine_runs_through_both_kernels(cuda_device):
    imax = 6
    q = HybridQuantizer(
        QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=4, imax=imax)),
        device=cuda_device,
    )
    img = natural_image(64, 80, seed=5)
    a0, f0 = ak.assign_opp_usage_pop.launches, ff.fused_scielab_err_sums.launches
    out, info = q.run(img)
    torch.cuda.synchronize()
    assert ak.assign_opp_usage_pop.launches - a0 == 1 + imax
    assert ff.fused_scielab_err_sums.launches - f0 == 1 + imax
    assert out.device.type == "cuda" and out.shape == (64, 80, 3)
    assert len(torch.unique(out.reshape(-1, 3), dim=0)) <= 8
    assert np.all(np.diff(info["telemetry"]["best_error"]) <= 0)
    mean, viz = q.error_image(img, out)
    assert torch.isfinite(mean) and viz.shape == (64, 80, 3)


def _distinct_near_tie(feats, pal):
    """(P,) bool: the two best scores over the palette's distinct entries
    lie within NEAR_TIE_REL * max(1, |score|) (f64; at least NEAR_TIE).
    Exact duplicates tie in every order."""
    c = torch.unique(pal.double(), dim=0)
    s = feats.double() @ c.T - 0.5 * (c * c).sum(-1)
    top2 = torch.topk(s, 2, dim=-1).values if c.shape[0] > 1 else torch.cat([s, s - 1], -1)
    bound = torch.clamp(NEAR_TIE_REL * top2[:, 0].abs(), min=NEAR_TIE)
    return (top2[:, 0] - top2[:, 1]) <= bound


@pytest.mark.parametrize("space", ["srgb", "lab"])
@pytest.mark.parametrize(
    "precision,tie_mode", [("bf16", "first"), ("f32x3", "average"), ("bf16", "average")]
)
def test_b1_fast_modes_match_plain(cuda_device, space, precision, tie_mode):
    img = torch.as_tensor(natural_image(150, 190, seed=6), device=cuda_device)
    pals = _rand((3, 64, 3), 12, cuda_device)
    pals[0, 3] = img[50, 60]  # wins at least that pixel
    pals[0, 7] = pals[0, 3]  # exact duplicates: every one of their scores ties
    pals[1, 40] = pals[1, 2]
    feats, pal_feats = img.reshape(-1, 3), pals
    if space == "lab":
        feats, pal_feats = cs.srgb_to_lab(feats), cs.srgb_to_lab(pals)
    feats, pal_feats, opps = feats.contiguous(), pal_feats.contiguous(), cs.srgb_to_opp(pals)
    kw = dict(precision=precision, tie_mode=tie_mode)
    before = ak.assign_opp_usage_pop.launches
    opp, counts, idx = ak.assign_opp_usage_pop(feats, pal_feats, opps, return_index=True, **kw)
    torch.cuda.synchronize()
    assert ak.assign_opp_usage_pop.launches == before + 1
    p_opp, p_counts, p_idx = ak.assign_opp_usage_pop_reference(feats, pal_feats, opps, **kw)
    if precision == "bf16":
        # the plain version repeats every bf16 score bit for bit
        assert torch.equal(idx, p_idx) and torch.equal(counts, p_counts)
        assert torch.equal(opp, p_opp)
    else:
        for p in range(3):
            ok = ~_distinct_near_tie(feats, pal_feats[p])
            assert torch.equal(idx[p][ok], p_idx[p][ok])
            assert torch.equal(opp[p][:, ok], p_opp[p][:, ok])
        assert (counts - p_counts).abs().sum() <= 2 * int((~ok).sum()) + 2
    if tie_mode == "average":
        assert bool((counts.sum(-1) >= feats.shape[0]).all())
        assert counts[0, 3] == counts[0, 7] > 0  # every tied entry is a hit
    else:
        assert bool((counts.sum(-1) == feats.shape[0]).all()) and counts[0, 7] == 0


@pytest.mark.parametrize("precision,tie_mode", [("f32x3", "first"), ("bf16", "average")])
def test_b1_image_axis_is_bit_equal_to_single_images(cuda_device, precision, tie_mode):
    feats = _rand((3, 97 * 131, 3), 13, cuda_device)
    pals = _rand((3, 4, 300, 3), 14, cuda_device)
    opps = cs.srgb_to_opp(pals)
    kw = dict(precision=precision, tie_mode=tie_mode, return_index=True)
    before = ak.assign_opp_usage_pop.launches
    batched = ak.assign_opp_usage_pop(feats, pals, opps, **kw)
    assert ak.assign_opp_usage_pop.launches == before + 1
    for i in range(3):
        single = ak.assign_opp_usage_pop(feats[i], pals[i], opps[i], **kw)
        for a, b in zip(batched, single):
            assert torch.equal(a[i], b)


def _b2_inputs(dev, B, H, W, seed):
    img = torch.as_tensor(np.stack([natural_image(H, W, seed=seed + i) for i in range(B)]), device=dev)
    target = torch.movedim(cs.srgb_to_lab(img), -1, 1).contiguous()
    q = cs.srgb_to_opp(torch.movedim(_rand((B, 3, 3, H, W), seed, dev), 2, -1))
    return torch.movedim(q, -1, 2).contiguous(), target


@pytest.mark.parametrize("kind", ["CIE76", "CIEDE2000"])
def test_b2_bf16_matches_plain(cuda_device, kind):
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    q, target = _b2_inputs(cuda_device, 1, 211, 333, 15)
    args = (q[0], target[0], kh, kv, cs.WHITEPOINT_D65, kind)
    got = ff.fused_scielab_err_sums(*args, precision="bf16")
    again = ff.fused_scielab_err_sums(*args, precision="bf16")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ff.fused_scielab_err_sums_reference(*args, precision="bf16")
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
    exact = ff.fused_scielab_err_sums(*args)
    assert not torch.equal(got, exact)  # the roundings took effect


@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
def test_b2_image_axis_is_bit_equal_to_single_images(cuda_device, precision):
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    q, target = _b2_inputs(cuda_device, 3, 64, 90, 16)
    before = ff.fused_scielab_err_sums.launches
    batched = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, precision=precision)
    assert ff.fused_scielab_err_sums.launches == before + 1 and batched.shape == (3, 3)
    for i in range(3):
        single = ff.fused_scielab_err_sums(q[i], target[i], kh, kv, cs.WHITEPOINT_D65, precision=precision)
        assert torch.equal(batched[i], single)


@pytest.mark.parametrize("fast", [False, True])
def test_batched_fitness_is_bit_equal_to_single_images(cuda_device, fast):
    kw = dict(precision="bf16", tie_mode="average") if fast else {}
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=16, population=4), assignment_space="lab", **kw)
    imgs = np.stack([natural_image(72, 96, seed=20 + i) for i in range(3)])
    pals = _rand((3, 4, 16, 3), 21, cuda_device)
    f = build_filters()
    err, use = make_population_fitness(_make_batch_context(imgs, f, cfg, cuda_device), cfg)(pals)
    for i in range(3):
        e, u = make_population_fitness(_make_context(imgs[i], f, cfg, cuda_device), cfg)(pals[i])
        assert torch.equal(err[i], e) and torch.equal(use[i], u)


def test_batch_engine_on_the_card_equals_single_image_runs(cuda_device):
    imax = 5
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=8, population=4, imax=imax), init="kmeans",
        precision="bf16", tie_mode="average", seed=3,
    )
    imgs = np.stack([natural_image(64, 80, seed=30 + i) for i in range(3)])
    a0, f0 = ak.assign_opp_usage_pop.launches, ff.fused_scielab_err_sums.launches
    palettes, info = BatchQuantizer(cfg, device=cuda_device).find_palettes(imgs)
    torch.cuda.synchronize()
    assert ak.assign_opp_usage_pop.launches - a0 == 1 + imax  # once per iteration, not per image
    assert ff.fused_scielab_err_sums.launches - f0 == 1 + imax
    for i in range(3):
        q = HybridQuantizer(dataclasses.replace(cfg, seed=3 + i), device=cuda_device)
        pal, single = q.find_palette(imgs[i])
        assert torch.equal(palettes[i], pal) and float(info["best_errors"][i]) == single["best_error"]
