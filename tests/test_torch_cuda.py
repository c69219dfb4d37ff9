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
from hybridquantization_tpu_torch.ops import probe_kernels as pk
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
POLISH_ATOL = 1e-5  # B3 Lloyd step against plain sums on its winners: f64 sums in another order
SUM_RTOL = 1e-5  # B2: f32 filters in another FMA order; sums reduced in f64 vs f32
# split-bf16 scores: the tensor cores' f32 accumulation against the plain
# version's sequential sum of the same 12 exact products (measured <= 4.8e-7 at 4K)
SPLIT_RTOL = 1e-6
# B2's split mode (the TPU kernel's f32x3), kernel against plain, relative:
# at these tests' 211 x 333 inputs 1.6e-7 at most on the tensor-core
# kernel (9 to 97 taps, shards included) and 8.0e-8 on the two-pass path
# (123 taps)
# (NVIDIA H100 80GB HBM3, 700 W; test_b2_split_matches_plain_on_every_path
# prints them under -rP); from 21 taps the fp32 mode must sit at least TEETH
# limits from the plain split on the same inputs (1.4e-6 to 6.3e-6)
B2_SPLIT_RTOL = 4e-7
TEETH = 3
# bf16 row maxima that may round the other way from plain (1e-5 measured at 4K;
# a truncating kernel puts about half of them one ulp off)
BF16_OFF_SHARE = 1e-4


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
    before = (ak.lloyd_step.launches, ak.assign_idx.launches)
    got = assign_ops.polish_palette(px.to(cuda_device), pal.to(cuda_device), space, cs.WHITEPOINT_D65, 10, "exact")
    torch.cuda.synchronize()
    assert (ak.lloyd_step.launches, ak.assign_idx.launches) == (before[0] + 10, before[1])
    want = assign_ops.polish_palette(px, pal, space, cs.WHITEPOINT_D65, 10, "exact")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _check_b3_batch(feats, pals):
    """B3's index mode on (F, P, 3) x (F, M, K, 3) against its plain version,
    problem by problem under the relative near-tie rule; (F, M, P) indices."""
    before = ak.assign_idx.launches
    idx = ak.assign_idx(feats, pals)
    torch.cuda.synchronize()
    assert ak.assign_idx.launches == before + 1
    F, M = pals.shape[:2]
    assert idx.dtype == torch.int32 and idx.shape == (F, M, feats.shape[1])
    for f in range(F):
        for m in range(M):
            want = ak.assign_idx_reference(feats[f], pals[f, m])
            diff = idx[f, m] != want
            if diff.any():
                (i,) = torch.nonzero(diff, as_tuple=True)
                x = feats[f, i].double()
                ca, cb = pals[f, m, idx[f, m, i].long()].double(), pals[f, m, want[i].long()].double()
                sa = (x * ca).sum(-1) - 0.5 * (ca * ca).sum(-1)
                sb = (x * cb).sum(-1) - 0.5 * (cb * cb).sum(-1)
                scale = torch.maximum(sa.abs(), sb.abs()).clamp_min(1.0)
                assert bool(((sa - sb).abs() <= NEAR_TIE_REL * scale).all())
    return idx


def _check_lloyd(feats, pals, weights):
    """B3's Lloyd-step mode on (F, P, 3) x (F, M, K, 3): one launch, within
    POLISH_ATOL of the plain sums (centroid_update) on the index mode's
    winners, which the plain version's equal off the near-tie class."""
    idx = _check_b3_batch(feats, pals)
    before = ak.lloyd_step.launches
    got = ak.lloyd_step(feats, pals, weights)
    torch.cuda.synchronize()
    assert ak.lloyd_step.launches == before + 1
    assert got.shape == pals.shape and got.dtype == torch.float32
    for f in range(feats.shape[0]):
        w = None if weights is None else weights[f]
        for m in range(pals.shape[1]):
            want = ak.centroid_update(feats[f], idx[f, m], pals[f, m], w)
            torch.testing.assert_close(got[f, m], want, rtol=0, atol=POLISH_ATOL)
            if torch.equal(idx[f, m], ak.assign_idx_reference(feats[f], pals[f, m])):
                torch.testing.assert_close(
                    got[f, m], ak.lloyd_step_reference(feats[f], pals[f, m], w), rtol=0, atol=POLISH_ATOL
                )
    return got, idx


@pytest.mark.parametrize("P", [1, 1023, 32_775])
@pytest.mark.parametrize("K", [7, 256, 1500])
def test_b3_both_modes_at_ragged_rows(cuda_device, P, K):
    feats = _rand((2, P, 3), 50 + K, cuda_device)
    pals = _rand((2, 3, K, 3), 51 + K, cuda_device)
    weights = torch.floor(_rand((2, P), 52, cuda_device) * 4)
    _check_lloyd(feats, pals, weights)
    _check_lloyd(feats, pals, None)


@pytest.mark.parametrize("space", ["srgb", "lab"])
def test_b3_lloyd_ties_nan_and_empty_entries(cuda_device, space):
    K = 1500  # two palette tiles of 1024 entries
    img = torch.as_tensor(natural_image(150, 190, seed=7), device=cuda_device).reshape(1, -1, 3)
    pals = _rand((1, 2, K, 3), 13, cuda_device)
    for a, b in ((15, 16), (31, 47), (1023, 1024), (5, 1400)):  # across chunk and tile edges
        pals[0, :, a] = img[0, 100 * a % img.shape[1]]
        pals[0, :, b] = pals[0, :, a]
    pals[0, :, 700] = 30.0  # nearest to no pixel
    img[0, [3, 1024, 9000]] = float("nan")  # no score is a number: dropped
    if space == "lab":
        img, pals = cs.srgb_to_lab(img).contiguous(), cs.srgb_to_lab(pals).contiguous()
    got, idx = _check_lloyd(img, pals, None)
    assert bool((idx[0, :, [3, 1024, 9000]] == -1).all())
    for a, b in ((15, 16), (31, 47), (1023, 1024), (5, 1400)):
        assert bool((idx == a).any()) and not bool((idx == b).any())
        assert torch.equal(got[0, :, b], pals[0, :, b])
    assert torch.equal(got[0, :, 700], pals[0, :, 700])


def test_b3_batched_launches_equal_single_ones_and_repeat(cuda_device):
    F, M, K, P = 3, 4, 256, 40_000
    feats = _rand((F, P, 3), 60, cuda_device)
    pals = _rand((F, M, K, 3), 61, cuda_device)
    weights = torch.floor(_rand((F, P), 62, cuda_device) * 5)
    idx = ak.assign_idx(feats, pals)
    steps = [ak.lloyd_step(feats, pals, weights) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(s, steps[0]) for s in steps[1:])
    for f in range(F):
        for m in range(M):
            assert torch.equal(ak.assign_idx(feats[f], pals[f, m]), idx[f, m])
            assert torch.equal(ak.lloyd_step(feats[f], pals[f, m], weights[f]), steps[0][f, m])


def test_b3_lloyd_large_k_route(cuda_device):
    feats = _rand((1, 20_000, 3), 70, cuda_device)
    for K, fused in ((ak.LLOYD_MAX_K, True), (ak.LLOYD_MAX_K + 1, False)):
        pals = _rand((1, 2, K, 3), 71, cuda_device)
        before = (ak.lloyd_step.launches, ak.lloyd_step.unfused_launches, ak.assign_idx.launches)
        got = ak.lloyd_step(feats, pals)
        torch.cuda.synchronize()
        after = (ak.lloyd_step.launches, ak.lloyd_step.unfused_launches, ak.assign_idx.launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((1, 0, 0) if fused else (0, 1, 1))
        idx = ak.assign_idx(feats, pals)
        for m in range(2):
            want = ak.centroid_update(feats[0], idx[0, m], pals[0, m])
            torch.testing.assert_close(got[0, m], want, rtol=0, atol=POLISH_ATOL)


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


def test_entry_on_the_card_matches_its_cpu_run(cuda_device):
    """tools.entry's population fitness (B1, B2) against its plain run."""
    from hybridquantization_tpu_torch.tools.entry import entry

    before = (ak.assign_opp_usage_pop.launches, ff.fused_scielab_err_sums.launches)
    fn, (pals,) = entry(cuda_device)
    got = fn(pals)
    torch.cuda.synchronize()
    assert (ak.assign_opp_usage_pop.launches, ff.fused_scielab_err_sums.launches) == (
        before[0] + 1, before[1] + 1)
    cpu_fn, (cpu_pals,) = entry("cpu")
    assert torch.equal(pals.cpu(), cpu_pals)
    torch.testing.assert_close(got.cpu(), cpu_fn(cpu_pals), rtol=0, atol=2e-5)


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


@pytest.mark.parametrize("precision", ["f32x3", "bf16", "split"])
def test_b2_image_axis_is_bit_equal_to_single_images(cuda_device, precision):
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    q, target = _b2_inputs(cuda_device, 3, 64, 90, 16)
    before = (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.band_launches)
    batched = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, precision=precision)
    split = precision == "split"  # on the tensor-core kernel
    assert (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.band_launches) == (
        before[0] + 1, before[1] + split) and batched.shape == (3, 3)
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


def _probe_inputs(P, K, pop, seed, dev, ones=True):
    """x4 (4, P) and packed palettes (pop, 4, K) with an exact duplicate entry."""
    g = np.random.default_rng(seed)
    x4 = torch.tensor(g.random((4, P), dtype=np.float32))
    if ones:
        x4[3] = 1.0
    pals = torch.tensor(g.random((pop, K, 3), dtype=np.float32))
    pals[0, min(5, K - 1)] = pals[0, 0]
    c4, o4 = pk.pack_palette(pals, pals)
    return x4.to(dev), c4.to(dev), o4.to(dev)


# P not a multiple of any block; K not a multiple of 8 or 16
PROBE_SHAPES = [(52073, 77, 4), (8 * 1024, 256, 4), (1000, 3, 2)]


@pytest.mark.parametrize("P,K,pop", PROBE_SHAPES)
def test_kloop_kernel_is_bit_equal_to_plain(cuda_device, P, K, pop):
    """T1/T2: every schedule gives the plain version's colours and counts bit for bit."""
    x4, c4, o4 = _probe_inputs(P, K, pop, P + K, cuda_device)
    c4[pop - 1, 0, K // 2] = float("nan")  # never wins
    want = pk.kloop_assign_reference(x4, c4, o4)
    before = pk.kloop_assign.launches
    runs = 0
    for slots in pk.SLOTS:
        for fused in (False, True):
            for unroll in pk.UNROLLS:
                opp, counts = pk.kloop_assign(x4, c4, o4, slots=slots, fused=fused, unroll=unroll)
                torch.cuda.synchronize()
                runs += 1
                assert torch.equal(opp, want[0]) and torch.equal(counts, want[1]), (slots, fused, unroll)
    assert pk.kloop_assign.launches == before + runs
    assert bool((want[1].sum(1) == P).all()) and want[1][pop - 1, K // 2] == 0


def _split_scores_close(got, want):
    """The tensor cores' f32 accumulation: within SPLIT_RTOL * max(1, |s|)."""
    return bool(((got - want).abs() <= SPLIT_RTOL * want.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("P,K,pop", PROBE_SHAPES)
@pytest.mark.parametrize("run", [None, 128, 100])
def test_split_rowmax_kernel_matches_plain(cuda_device, P, K, pop, run):
    x4, c4, _ = _probe_inputs(P, K, pop, 2 * P + K, cuda_device, ones=run is None)
    if run is not None:
        g = torch.Generator().manual_seed(K)
        c4 = torch.rand((pop, -(-P // run), 4, K), generator=g).to(cuda_device)
    before = pk.split_rowmax.launches
    got = pk.split_rowmax(x4, c4, run=run)
    bf = pk.split_rowmax(x4, c4, run=run, out_bf16=True)
    torch.cuda.synchronize()
    assert pk.split_rowmax.launches == before + 2
    want = pk.split_rowmax_reference(x4, c4, run=run)
    assert _split_scores_close(got, want)
    # rounded scores: the kernel rounds its own f32 maximum, within SPLIT_RTOL
    # of the plain one, so it may round the other way only where a rounding
    # boundary lies that close, and that on few outputs
    d = SPLIT_RTOL * want.abs().clamp_min(1.0)
    assert bool(((bf >= ak.bf16_round(want - d)) & (bf <= ak.bf16_round(want + d))).all())
    bf_want = pk.split_rowmax_reference(x4, c4, run=run, out_bf16=True)
    assert int((bf != bf_want).sum()) <= max(1.0, BF16_OFF_SHARE * bf.numel())
    assert torch.equal(bf, ak.bf16_round(bf))
    # the kernel rounds its own f32 maximum once: bit for bit its f32 output's rounding
    assert torch.equal(bf, ak.bf16_round(got))


@pytest.mark.parametrize("K", [3, 77, 200, 256, 300])
@pytest.mark.parametrize("run", [None, 100])
def test_split_rowmax_nan_pixels_nan_candidates_and_duplicates(cuda_device, K, run):
    """Max mode at both product widths (N = 64; N = 128 over one to three
    chunks, the last ragged): a pixel whose scores are all NaN gets -inf in
    both outputs, a NaN candidate never enters the max (the other maxima
    stay within SPLIT_RTOL of plain, duplicate candidates beside them), and
    the bf16 output is the rounding of the f32 output."""
    P = 20011
    x4, c4, _ = _probe_inputs(P, K, 4, 13 * K + (run or 0), cuda_device, ones=run is None)
    if run is not None:
        g = torch.Generator().manual_seed(K)
        c4 = torch.rand((4, -(-P // run), 4, K), generator=g).to(cuda_device)
    nan_px = torch.arange(3, P, 997, device=cuda_device)
    x4[:, nan_px] = float("nan")
    c4[..., 1, K // 2] = float("nan")
    c4[..., K - 1] = c4[..., 0]
    got = pk.split_rowmax(x4, c4, run=run)
    bf = pk.split_rowmax(x4, c4, run=run, out_bf16=True)
    torch.cuda.synchronize()
    want = pk.split_rowmax_reference(x4, c4, run=run)
    assert bool((got[:, nan_px] == float("-inf")).all()) and bool((bf[:, nan_px] == float("-inf")).all())
    assert bool((want[:, nan_px] == float("-inf")).all()) and not bool(torch.isnan(got).any())
    rest = torch.ones(P, dtype=torch.bool, device=cuda_device)
    rest[nan_px] = False
    assert _split_scores_close(got[:, rest], want[:, rest])
    assert torch.equal(bf, ak.bf16_round(got))


def _check_split_assign(x4, c, o, run, tie_mode, parts):
    """split_assign on the card against its plain version: indices, colours
    and counts differ only at pixels in the relative near-tie class."""
    opp, counts, idx = pk.split_assign(x4, c, o, run=run, tie_mode=tie_mode, opp_parts=parts,
                                       return_index=True)
    torch.cuda.synchronize()
    p_opp, p_counts, p_idx = pk.split_assign_reference(x4, c, o, run=run, tie_mode=tie_mode,
                                                       opp_parts=parts, return_index=True)
    # pixels whose winner (or, averaging, set of hits) differs: their two
    # best plain scores must lie in the near-tie class
    differ = (idx != p_idx) | (opp != p_opp).any(1)
    n_diff, in_class = int(differ.sum()), 0
    if n_diff:
        m, i = torch.nonzero(differ, as_tuple=True)
        cands = c[m] if run is None else c[m, i // run]
        s = pk._split_scores(x4[:, i][:, :, None], cands)[:, 0]  # (n_diff, Kc) plain scores
        s = torch.where(torch.isnan(s), float("-inf"), s)  # a NaN score never wins
        top, second = torch.topk(s, 2, dim=-1).values.unbind(-1)
        near = NEAR_TIE_REL * top.abs().clamp_min(1.0)
        assert bool(((top - second) <= near).all())
        in_class = int((s >= (top - near)[:, None]).sum())
    # a differing pixel moves one count from one entry to another; averaging,
    # only the candidates of its near-tie class change their hits
    limit = 2 * n_diff if tie_mode == "first" else in_class
    assert int((counts - p_counts).abs().sum()) <= limit
    return counts, idx


@pytest.mark.parametrize("P,K,pop", PROBE_SHAPES)
@pytest.mark.parametrize("tie_mode,parts", [("first", 3), ("first", 2), ("average", 3)])
def test_split_assign_dense_kernel_matches_plain(cuda_device, P, K, pop, tie_mode, parts):
    x4, c4, o4 = _probe_inputs(P, K, pop, 3 * P + K, cuda_device)
    before = pk.split_assign.launches
    counts, _ = _check_split_assign(x4, c4, o4, None, tie_mode, parts)
    assert pk.split_assign.launches == before + 1
    if tie_mode == "first":
        assert bool((counts.sum(1) == P).all())
    else:
        assert bool((counts.sum(1) >= P).all())


@pytest.mark.parametrize("P", [52073, 8 * 1024])
@pytest.mark.parametrize("run", [128, 256, 100])
def test_split_assign_per_run_kernel_matches_plain(cuda_device, P, run):
    g = torch.Generator().manual_seed(P + run)
    x4 = torch.rand((4, P), generator=g).to(cuda_device)
    c = torch.rand((4, -(-P // run), 4, 64), generator=g).to(cuda_device)
    c[:, :, :, 7] = c[:, :, :, 3]
    counts, idx = _check_split_assign(x4, c, c, run, "first", 2)
    assert bool((counts.sum(1) == P).all()) and int(counts[:, 7].sum()) == 0


def test_probe_wrappers_raise_without_the_library(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel or raises; it never runs the plain version."""
    from hybridquantization_tpu_torch.ops import _cuda

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_cuda, "library", no_library)
    x4, c4, o4 = _probe_inputs(1000, 16, 2, 1, cuda_device)
    for call in (lambda: pk.kloop_assign(x4, c4, o4), lambda: pk.split_rowmax(x4, c4),
                 lambda: pk.split_assign(x4, c4, o4)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


def test_probe_tools_run_on_the_card(cuda_device):
    from hybridquantization_tpu_torch.tools import kexp_assign, minidot_probe, vpu_assign_exp

    before = (pk.kloop_assign.launches, pk.split_rowmax.launches, pk.split_assign.launches)
    vpu_assign_exp.main(["vpu,vpu_fused,grp8,dotbf16,cur", "128"], shape=(64, 128))
    kexp_assign.main([",".join(kexp_assign.VARIANTS), "256"], shape=(64, 128))
    minidot_probe.main(["dense", "mini256", "minifull128"], shape=(64, 128))
    after = (pk.kloop_assign.launches, pk.split_rowmax.launches, pk.split_assign.launches)
    assert all(a > b for a, b in zip(after, before))


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


def _b2s_shards(q, target, kh, kv, cols, kind, precision):
    """B2s over the column ranges `cols`, guards from the neighbours or
    mirrored at the image's borders, as parallel.fast builds them."""
    half = kh.shape[1] // 2
    W = q.shape[-1]
    out = []
    for lo, hi in cols:
        left = q[..., lo - half:lo] if lo else q[..., :half].flip(-1)
        right = q[..., hi:hi + half] if hi < W else q[..., hi - half:hi].flip(-1)
        args = (q[..., lo:hi].contiguous(), target[..., lo:hi].contiguous(), kh, kv, cs.WHITEPOINT_D65, kind)
        kw = dict(precision=precision, left_slab=left.contiguous(), right_slab=right.contiguous())
        out.append((ff.fused_scielab_err_sums(*args, **kw), ff.fused_scielab_err_sums_reference(*args, **kw)))
    return out


@pytest.mark.parametrize("kind", ["CIE76", "CIE94", "CIEDE2000"])
@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
def test_b2_slabs_kernel_matches_plain(cuda_device, kind, precision):
    """B2s on 3 shards of a 211 x 333 frame (one 10 columns wide): each
    shard against its plain version, their total against mirror B2's."""
    H, W = 211, 333
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    img = torch.as_tensor(natural_image(H, W, seed=4), device=cuda_device)
    target = torch.movedim(cs.srgb_to_lab(img), -1, 0).contiguous()
    q = torch.movedim(cs.srgb_to_opp(torch.movedim(_rand((3, 3, H, W), 5, cuda_device), 1, -1)), -1, 1).contiguous()
    before = ff.fused_scielab_err_sums.slab_launches
    shards = _b2s_shards(q, target, kh, kv, ((0, 150), (150, 160), (160, W)), kind, precision)
    torch.cuda.synchronize()
    assert ff.fused_scielab_err_sums.slab_launches == before + 3
    for got, want in shards:
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
    whole = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, kind, precision=precision)
    total = sum(g.double() for g, _ in shards)
    torch.testing.assert_close(total, whole.double(), rtol=SUM_RTOL, atol=0)
    # guards mirrored at both borders read what mirror B2 reads, in its order
    (mirrored, _), = _b2s_shards(q, target, kh, kv, ((0, W),), kind, precision)
    assert torch.equal(mirrored, whole)


def test_two_gloo_ranks_share_the_card(cuda_device):
    """Two gloo ranks on one card (the host copies of parallel.mesh): the
    column-sharded engine's fitness equals the one-device fitness, and both
    ranks agree bit for bit after a k-means-seeded anneal."""
    from hybridquantization_tpu_torch.ops import _cuda
    from hybridquantization_tpu_torch.parallel.multihost import launch

    from . import _torch_mesh_worker as w

    _cuda.library()  # built once, before the ranks start
    ranks = launch(w.card_ranks, 2, device="cuda", backend="gloo")
    for k, v in ranks[0].items():
        assert np.array_equal(np.asarray(v), np.asarray(ranks[1][k])) or k == "device", k
    cfg = w.engine_config()
    imgs = torch.as_tensor(w.engine_images(), device=cuda_device)
    pals = torch.as_tensor(np.stack([w.col_palettes()[:2, :4]] * 2), device=cuda_device)
    err, use = make_population_fitness(_make_batch_context(imgs, build_filters(), cfg, cuda_device), cfg)(pals)
    np.testing.assert_allclose(ranks[0]["err"], err.cpu().numpy(), rtol=SUM_RTOL)
    np.testing.assert_array_equal(ranks[0]["use"], use.cpu().numpy())
    imax = cfg.swasa.imax
    assert ranks[0]["launches"] == (2 * (1 + imax), 2 * (1 + imax))  # member-pipelined: one per member


def _b2_check(q, target, kh, kv, kind="CIE76", precision="f32x3", **guards):
    """B2 against its plain version (SUM_RTOL; B2_SPLIT_RTOL in split mode)
    and against itself run to run."""
    args = (q, target, kh, kv, cs.WHITEPOINT_D65, kind)
    got = ff.fused_scielab_err_sums(*args, precision=precision, **guards)
    again = ff.fused_scielab_err_sums(*args, precision=precision, **guards)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ff.fused_scielab_err_sums_reference(*args, precision=precision, **guards)
    torch.testing.assert_close(got, want, rtol=B2_SPLIT_RTOL if precision == "split" else SUM_RTOL, atol=0)
    return got


@pytest.mark.parametrize("precision", ["f32x3", "bf16", "split"])
@pytest.mark.parametrize("H,W", [(11, 11), (12, 300), (33, 65), (257, 31), (70, 97), (100, 63), (130, 64),
                                 (190, 65)])
def test_b2_fused_kernel_at_ragged_and_narrow_shapes(cuda_device, precision, H, W):
    """H and W off the fused kernel's 32 x 32 tile and 512-row segment, and
    off split mode's 64-column strips and 64-row tiles (widths one under, at
    and one over a strip), down to one column more than the filter's
    half-width (10). Split mode runs the tensor-core kernel, counted apart."""
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    q, target = _b2_inputs(cuda_device, 2, H, W, 40)
    counts = (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.two_pass_launches,
              ff.fused_scielab_err_sums.band_launches)
    before = counts
    got = _b2_check(q, target, kh, kv, "CIEDE2000", precision)
    assert got.shape == (2, 3)
    counts = (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.two_pass_launches,
              ff.fused_scielab_err_sums.band_launches)
    assert counts == (before[0] + 2, before[1], before[2] + 2 * (precision == "split"))


def _random_filters(taps, seed, dev):
    g = torch.Generator().manual_seed(seed)
    k = torch.rand((2, 7, taps), generator=g)
    k /= k.sum(-1, keepdim=True)
    return k[0].contiguous().to(dev), k[1].contiguous().to(dev)


@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
def test_b2_fused_and_two_pass_paths_around_the_tap_limit(cuda_device, precision, monkeypatch):
    """MAX_FUSED_TAPS runs the fused kernel, two more taps the two-pass path;
    both against their plain versions, counted apart. Then the fused kernel
    at the largest filter its shared-memory layout holds (97 taps), where the
    plan's shared bytes must cover the kernel's layout."""
    q, target = _b2_inputs(cuda_device, 1, 130, 150, 41)

    def run(taps, two_pass):
        kh, kv = _random_filters(taps, taps, cuda_device)
        before = ff.fused_scielab_err_sums.two_pass_launches
        _b2_check(q[0], target[0], kh, kv, "CIE94", precision)
        assert ff.fused_scielab_err_sums.two_pass_launches - before == two_pass, taps
        assert ff.fused_plan(130, 150, taps)["path"] == ("two_pass" if two_pass else "fused")

    run(ff.MAX_FUSED_TAPS, 0)
    run(ff.MAX_FUSED_TAPS + 2, 2)
    run(3, 0)
    assert ff.fused_smem_bytes(97) <= ff.SMEM_LIMIT < ff.fused_smem_bytes(99)
    monkeypatch.setattr(ff, "MAX_FUSED_TAPS", 97)
    run(97, 0)


@pytest.mark.parametrize("precision", ["f32x3", "bf16", "split"])
def test_b2_slabs_on_shards_narrower_than_a_tile(cuda_device, precision):
    """B2s on shards of 12, 13, 31 and 14 columns of a 90 x 70 frame (at
    least the filter's half-width, 10, as the column plan requires; under
    the fused kernel's 32 and split mode's 64): each against its plain
    version, their total against mirror B2's."""
    f = build_filters()
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    q, target = _b2_inputs(cuda_device, 1, 90, 70, 42)
    q, target = q[0], target[0]
    cols = ((0, 12), (12, 25), (25, 56), (56, 70))
    rtol = B2_SPLIT_RTOL if precision == "split" else SUM_RTOL
    before = ff.fused_scielab_err_sums.band_launches
    shards = _b2s_shards(q, target, kh, kv, cols, "CIE76", precision)
    torch.cuda.synchronize()
    assert ff.fused_scielab_err_sums.band_launches - before == 4 * (precision == "split")
    for got, want in shards:
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    whole = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, precision=precision)
    torch.testing.assert_close(sum(g.double() for g, _ in shards), whole.double(), rtol=rtol, atol=0)


def _check_b1_modes(feats, pals, precision, tie_mode):
    """B1 against its plain version: bf16 equal everywhere; fp32 equal off
    the distinct near-tie class, counts within 2 per such pixel."""
    opps = cs.srgb_to_opp(pals)
    kw = dict(precision=precision, tie_mode=tie_mode)
    opp, counts, idx = ak.assign_opp_usage_pop(feats, pals, opps, return_index=True, **kw)
    torch.cuda.synchronize()
    p_opp, p_counts, p_idx = ak.assign_opp_usage_pop_reference(feats, pals, opps, **kw)
    if precision == "bf16":
        assert torch.equal(idx, p_idx) and torch.equal(counts, p_counts) and torch.equal(opp, p_opp)
    else:
        near = 0
        for p in range(pals.shape[0]):
            real = ~torch.isnan(pals[p]).any(-1)
            ok = ~_distinct_near_tie(feats, pals[p][real]) & ~torch.isnan(feats).any(-1)
            assert torch.equal(idx[p][ok], p_idx[p][ok])
            assert torch.equal(opp[p][:, ok], p_opp[p][:, ok])
            near += int((~ok).sum())
        assert (counts - p_counts).abs().sum() <= 2 * near
    return opp, counts, idx


@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
@pytest.mark.parametrize("tie_mode", ["first", "average"])
def test_b1_duplicates_straddling_chunk_and_tile_boundaries(cuda_device, precision, tie_mode):
    """Exact duplicates on both sides of a scan chunk (8 and 16 entries) and
    of the 1024-entry shared tile, and across tiles: the first copy wins;
    averaging, every copy is a hit."""
    K = 1100
    feats = _rand((40000, 3), 50, cuda_device)
    pals = _rand((2, K, 3), 51, cuda_device)
    pairs = ((7, 8), (15, 16), (15, 17), (31, 32), (1023, 1024), (3, 1030))
    for a, b in pairs:
        pals[:, b] = pals[:, a]
    for a, b in pairs:  # each pair wins at least the pixel at its own colour
        feats[a] = pals[0, a]
    _, counts, idx = _check_b1_modes(feats, pals, precision, tie_mode)
    for a, b in pairs:
        assert int(idx[0, a]) == a
        if tie_mode == "first":
            assert counts[0, b] == 0 and counts[0, a] > 0
        else:
            assert counts[0, a] == counts[0, b] > 0


@pytest.mark.parametrize("K", [1, 17, 1025, 4097])
@pytest.mark.parametrize("precision,tie_mode", [("f32x3", "first"), ("bf16", "first"), ("f32x3", "average"),
                                                ("bf16", "average")])
def test_b1_nan_entries_ragged_pixels_and_palette_sizes(cuda_device, K, precision, tie_mode):
    """P = 52073 (not a multiple of pixels per thread x threads), a NaN
    pixel, NaN entries (never a winner) and K about the scan's chunk, tile
    and histogram sizes."""
    feats = _rand((173 * 301, 3), 60 + K, cuda_device)
    feats[9] = float("nan")
    pals = _rand((3, K, 3), 61 + K, cuda_device)
    if K > 1:
        pals[0, K // 2] = float("nan")
        pals[2, 0] = float("nan")
    opp, counts, idx = _check_b1_modes(feats, pals, precision, tie_mode)
    assert bool((idx[:, 9] == -1).all()) and bool((opp[:, :, 9] == 0).all())
    if K > 1:
        assert counts[0, K // 2] == 0 and counts[2, 0] == 0
    total = counts.sum(-1)
    assert bool((total == feats.shape[0] - 1).all() if tie_mode == "first" else (total >= feats.shape[0] - 1).all())


def _kloop_hazard_inputs(P, K, pop, seed, dev):
    """Probe inputs with the k-loop's hazards: exact duplicates on both sides
    of a 16-entry chunk, of T2's 128-entry chunk row and of the 1024-entry
    staged tile; NaN entries; entries scoring exactly -1e30 or below; and a
    member whose every score is at or below -1e30 (no winner: colour 0, no
    count)."""
    x4, c4, o4 = _probe_inputs(P, K, pop, seed, dev)
    pairs = [(a, b) for a, b in ((15, 16), (127, 128), (3, 20), (1023, 1024), (7, 2100)) if b < K]
    for a, b in pairs:
        c4[:, :, b] = c4[:, :, a]
        o4[:, :, b] = o4[:, :, a] + 1.0  # a wrong winner shows in the colour
    for a, b in pairs[:3]:
        x4[:3, a] = c4[0, :3, a]  # each first copy wins some pixel
    if K > 2:
        c4[0, :, K - 2] = float("nan")
        c4[pop - 1, :3, K - 1] = 0.0
        c4[pop - 1, 3, K - 1] = pk.NEG  # scores exactly -1e30: never wins
    if pop > 1:
        c4[1, :3] = 0.0
        c4[1, 3] = 2 * pk.NEG  # every score of member 1 below -1e30
    return x4, c4, o4, pairs


@pytest.mark.parametrize("K", [3, 77, 300, 3000])
@pytest.mark.parametrize("pop", [1, 8])
def test_kloop_hazards_bit_equal_for_every_schedule(cuda_device, K, pop):
    """T1/T2 at K about the 16-entry chunk, T2's 128-entry chunk row, the
    1024-entry tile (3000: streamed in three tiles), pop 1 and pop 8 (fused
    in one pass of 8 chains): every slots/fused/unroll/threads schedule gives
    the plain version's colours and counts bit for bit."""
    P = 5000 + K
    x4, c4, o4, pairs = _kloop_hazard_inputs(P, K, pop, 7 * K + pop, cuda_device)
    want = pk.kloop_assign_reference(x4, c4, o4)
    if pop > 1:
        assert bool((want[0][1] == 0).all()) and int(want[1][1].sum()) == 0
    for a, b in pairs:
        assert int(want[1][0, b]) == 0
    before, runs = pk.kloop_assign.launches, 0
    for slots in pk.SLOTS:
        for fused in (False, True):
            for unroll in pk.UNROLLS:
                for threads in (32, 96, 256):
                    opp, counts = pk.kloop_assign(x4, c4, o4, slots=slots, fused=fused, unroll=unroll,
                                                  threads=threads)
                    torch.cuda.synchronize()
                    runs += 1
                    key = (slots, fused, unroll, threads)
                    assert torch.equal(opp, want[0]) and torch.equal(counts, want[1]), key
    assert pk.kloop_assign.launches == before + runs


@pytest.mark.parametrize("P", [1, 100, 5000])
def test_kloop_fewer_pixels_than_one_wave(cuda_device, P):
    x4, c4, o4 = _probe_inputs(P, 256, 4, P, cuda_device)
    want = pk.kloop_assign_reference(x4, c4, o4)
    for slots in pk.SLOTS:
        for fused, threads in ((False, 512), (False, 256), (True, 256)):
            got = pk.kloop_assign(x4, c4, o4, slots=slots, fused=fused, threads=threads)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (slots, fused)


@pytest.mark.parametrize("K", [3, 77, 256, 300])
@pytest.mark.parametrize("tie_mode,parts", [("first", 3), ("average", 3), ("first", 2)])
def test_split_assign_duplicates_nan_and_ragged_k(cuda_device, K, tie_mode, parts):
    """T4 at K not a multiple of 8, 16 or 64 (the last wgmma chunk masked),
    with exact duplicate candidates on both sides of an 8-candidate group and
    of the 128-candidate chunk, and NaN candidates: a duplicate never wins in
    first mode; averaging, the copies' hits are equal (the same held values
    tie exactly); NaN never wins."""
    P = 20000 + K
    x4, c4, o4 = _probe_inputs(P, K, 4, 11 * K, cuda_device)
    pairs = [(a, b) for a, b in ((7, 8), (1, 2), (127, 128), (5, 260)) if b < K]
    for a, b in pairs:
        c4[:, :, b] = c4[:, :, a]
        o4[:, :, b] = o4[:, :, a] + 1.0
    for a, _ in pairs:
        x4[:3, a] = c4[0, :3, a]
    nan_k = 0 if any(K - 1 in pair for pair in pairs) else K - 1
    c4[2, 0, nan_k] = float("nan")
    counts, idx = _check_split_assign(x4, c4, o4, None, tie_mode, parts)
    assert int(counts[2, nan_k]) == 0 and not bool((idx[2] == nan_k).any())
    for a, b in pairs:
        if tie_mode == "first":
            assert int(counts[0, b]) == 0
        else:
            assert torch.equal(counts[:, a], counts[:, b])
    total = counts.sum(1)
    assert bool((total == P).all()) if tie_mode == "first" else bool((total >= P).all())


@pytest.mark.parametrize("P", [1, 100, 1000])
@pytest.mark.parametrize("tie_mode", ["first", "average"])
def test_split_assign_fewer_pixels_than_one_wave(cuda_device, P, tie_mode):
    x4, c4, o4 = _probe_inputs(P, 256, 4, 5 * P, cuda_device)
    counts, _ = _check_split_assign(x4, c4, o4, None, tie_mode, 3)
    assert bool((counts.sum(1) == P).all()) if tie_mode == "first" else bool((counts.sum(1) >= P).all())


@pytest.mark.parametrize("run", [100, 128, 256])
@pytest.mark.parametrize("tie_mode", ["first", "average"])
def test_split_assign_per_run_ragged_runs_and_duplicates(cuda_device, run, tie_mode):
    """Per-run candidates through the cp.async ring: run = 100 (tiles of 64
    and 36 pixels), P not a multiple of the run, duplicates in every run's
    candidates (averaging: equal hits)."""
    P = 30011
    g = torch.Generator().manual_seed(run)
    x4 = torch.rand((4, P), generator=g).to(cuda_device)
    c = torch.rand((4, -(-P // run), 4, 64), generator=g).to(cuda_device)
    c[:, :, :, 40] = c[:, :, :, 9]
    counts, idx = _check_split_assign(x4, c, c, run, tie_mode, 2)
    if tie_mode == "first":
        assert bool((counts.sum(1) == P).all()) and int(counts[:, 40].sum()) == 0
    else:
        assert torch.equal(counts[:, 9], counts[:, 40])


@pytest.mark.parametrize("dpi,dist", [(30, 45.0), (72, 45.0), (96, 45.0), (222, 45.0), (312, 45.0), (300, 60.0)])
def test_b2_split_matches_plain_on_every_path(cuda_device, dpi, dist):
    """B2's split mode (the TPU kernel's f32x3) against its plain version:
    the tensor-core kernel (csrc/band_fitness.cu) at 9, 21 (the default,
    its band tables made once for the stacks), 29, 69 and 97 taps (the
    limit), the two-pass path at 123; bit-equal twice; the image axis
    bit-equal to each image alone; B2s over 3 shards; and, from 21 taps,
    the fp32 mode at least TEETH limits from the plain split."""
    f = build_filters(dpi, dist)
    kh, kv = stacked_kernels(f, False, cuda_device), stacked_kernels(f, True, cuda_device)
    host = {"taps_on_host": ff.kernel_taps(kh, kv)}
    q, target = _b2_inputs(cuda_device, 2, 211, 333, 17)
    counts = (ff.fused_scielab_err_sums.split_launches, ff.fused_scielab_err_sums.two_pass_launches,
              ff.fused_scielab_err_sums.band_launches)
    before = counts
    got = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, "CIEDE2000", precision="split", **host)
    again = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, "CIEDE2000", precision="split", **host)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    path = ff.fused_plan(211, 333, kh.shape[1], split=True)["path"]
    assert path == ("two_pass" if kh.shape[1] > ff.MAX_FUSED_TAPS else "band")
    counts = (ff.fused_scielab_err_sums.split_launches, ff.fused_scielab_err_sums.two_pass_launches,
              ff.fused_scielab_err_sums.band_launches)
    assert counts == (before[0] + 2, before[1] + 2 * (path == "two_pass"), before[2] + 2 * (path == "band"))
    want = ff.fused_scielab_err_sums_reference(q, target, kh, kv, cs.WHITEPOINT_D65, "CIEDE2000",
                                               precision="split")
    fp32 = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, "CIEDE2000", **host)
    torch.testing.assert_close(got, want, rtol=B2_SPLIT_RTOL, atol=0)
    rel, far = (((x.double() - want.double()).abs() / want.double().abs()).max().item() for x in (got, fp32))
    # the teeth from the default filter up; at 9 taps the two modes sit
    # closer than TEETH limits on these inputs (9.3e-7 measured), so there
    # the limit and the bit-equalities hold the kernel, not the teeth
    assert far >= TEETH * B2_SPLIT_RTOL or kh.shape[1] < ff.DEFAULT_TAPS, (far, "the fp32 mode would pass as split")
    for i in range(2):
        single = ff.fused_scielab_err_sums(q[i], target[i], kh, kv, cs.WHITEPOINT_D65, "CIEDE2000",
                                           precision="split", **host)
        assert torch.equal(got[i], single)
    # the shards hold the guards in split mode; a shard alone may not tell
    # the modes apart at this limit (the fp32 mode's distance per shard is
    # printed), so the split's arithmetic is held by the whole frame above
    cols = ((0, 150), (150, 230), (230, 333))
    shards = _b2s_shards(q[0], target[0], kh, kv, cols, "CIE76", "split")
    for g, w in shards:
        torch.testing.assert_close(g, w, rtol=B2_SPLIT_RTOL, atol=0)
    whole = ff.fused_scielab_err_sums(q[0], target[0], kh, kv, cs.WHITEPOINT_D65, "CIE76", precision="split")
    torch.testing.assert_close(sum(g.double() for g, _ in shards), whole.double(), rtol=B2_SPLIT_RTOL, atol=0)

    def _rel(x, w):
        return ((x.double() - w.double()).abs() / w.double().abs()).max().item()

    fp32_shards = _b2s_shards(q[0], target[0], kh, kv, cols, "CIE76", "f32x3")
    print(f"B2 split at {kh.shape[1]} taps: {rel:.3g} from plain (shards "
          f"{max(_rel(g, w) for g, w in shards):.3g}), the fp32 mode {far:.3g} (shards "
          + ", ".join(f"{_rel(f, w):.3g}" for (f, _), (_, w) in zip(fp32_shards, shards)) + ")")
