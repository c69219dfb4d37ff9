#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`hybridquantization_tpu_torch/csrc/` (one nvcc per source, in parallel),
holds each against its plain torch version at the shapes the paths below
give it (B1 and B2: a 3840x2160 frame at K=256 and a 1024x768 frame at
K=64, population 4; B3 on one palette: both frames in sRGB and in LAB, and
the 2^15- and 2^18-bin colour histograms of the k-means seeding and the
histogram polish), and B1's and B2's fast variants (bf16 scores, the
"average" tie mode, a bf16 filter) at 4K in sRGB and LAB, checks the
annealing slice and the exact Lloyd polish against the plain path on small
inputs, then drives five paths at full width, each with the launch counts
set to 0 just before it and read just after:

  e2e               random init, imax=30: `HybridQuantizer(...).run` and
                    `error_image` (B1, B2; B3 in quantize);
  quality schedule  k-means seeds, imax=50, `.polish` (histogram at 4K),
                    `quantize`, `error_image` (B1, B2; B3 in every Lloyd
                    step and quantize), then the exact polish at 4K (B3);
  cli               `cli.main(["quantize", ...])` on a 1024x768 `.ppm` with
                    every flag of the flow (exact polish through B3), a
                    resumed second run from its checkpoint, and `error`;
  fast schedule     the quality schedule with precision="bf16" and
                    tie_mode="average" (what `quantize --fast` runs), timed
                    warm in turns with the exact one (exact, fast, fast,
                    exact);
  batch             `quantize-batch --fast --init kmeans --imax 50 --polish
                    10 --error-images` at K=256, pop 4 over 64 PPMs, 16 each
                    of 1920x1080, 1280x720, 1024x768 and 640x480: the 64
                    through the engine and bucketing the command uses
                    (`parallel.BatchQuantizer` + `batching.run_bucketed`),
                    bucket by bucket, with B1/B2 launched once per iteration
                    per bucket; after each bucket's count, its batched
                    fitness is held bit-equal to its images' own, and its
                    image-axis B1 (bf16, average) and B2 (bf16) launches and
                    B3 on its first image are held against their plain
                    versions; then the command itself on four of the
                    files, one per resolution, whose outputs must equal the
                    engine's for the same images and seeds.

The command writes only those four images and their error images: PNG
encoding of all 64 (and 64 error images) would spend tens of seconds of
host time in PIL that measure nothing of the port.

Each phase prints a line or a few. Before the last line it prints the card's
name and power limit and a JSON object with one entry per kernel (at top
level its numbers at the batch's largest bucket and its launches there);
the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
so does a machine without a CUDA device.

Imports torch, numpy, the standard library and the port; never jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

H, W, K, POP, IMAX = 2160, 3840, 256, 4, 30
CLI_H, CLI_W, CLI_K, CLI_IMAX = 768, 1024, 64, 40  # the cli phase's frame
QS_IMAX = 50      # the quality schedule's anneal (bench.py's E2E_ANNEAL_ITERS)
POLISH = 10       # Lloyd polish steps
SEED_STEPS = POP * 25  # kmeans_init_palettes: 25 weighted Lloyd steps (B3) per member
NEAR_TIE = 1e-5   # B1: |score gap| (f64) within which f32 rounding may pick either entry
# B3: near ties are relative, since LAB scores reach ~1e4 where one f32 ulp
# is ~1e-3: |gap| <= NEAR_TIE_REL * max(1, |score|) of the two entries
NEAR_TIE_REL = 1e-6
B2_RTOL = 1e-5    # B2: relative difference of each member's Delta-E sum
SMALL_ATOL = 2e-5  # slice on a small input, card vs plain path: fitness values
POLISH_ATOL = 1e-5  # 10 exact Lloyd steps on a small input, card vs plain path
CLI_DE_RTOL = 1e-5  # cli `error` vs error_image on the same two files
# the batch phase: 16 images of each size, image i of size BATCH_SIZES[i % 4] from seed i
BATCH_SIZES = ((1080, 1920), (720, 1280), (768, 1024), (480, 640))
BATCH_IMAGES = 64
B3_PER_IMAGE = SEED_STEPS + POLISH + 1  # k-means seeding, polish, quantize

# NVIDIA H100 SXM data sheet peaks (700 W): fp32 outside the tensor cores,
# dense bf16 on the tensor cores, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events over n calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(flops: float, nbytes: float, bf16: bool = False) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes (each input read once, each
    output written once) over the memory rate. No single PyTorch call
    computes any of the three kernels' functions, so library_ms is null."""
    ops_ms = flops / (PEAK_BF16 if bf16 else PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}


def b1_bound(P: int, K: int, pop: int, bf16: bool = False, images: int = 1) -> dict:
    """B1: 3 multiply-adds per (pixel, entry, member); features, palettes and
    opponent palettes in, opponent image and counts out."""
    return bound(6.0 * images * P * K * pop,
                 4.0 * images * (3 * P + 6 * pop * K + 3 * pop * P + pop * K), bf16)


def b2_bound(H: int, W: int, taps: int, pop: int, bf16: bool = False, images: int = 1) -> dict:
    """B2: 7 filters x taps multiply-adds per pass, two passes, per member
    pixel (the LAB and Delta-E tail is left out, under a tenth of it);
    opponent images and targets in, sums out."""
    members = images * pop
    return bound(2.0 * 2 * 7 * taps * members * H * W,
                 4.0 * (3 * members * H * W + 3 * images * H * W + 14 * taps + members), bf16)


def b3_bound(P: int, K: int) -> dict:
    """B3: 3 multiply-adds per (pixel, entry); features and palette in, indices out."""
    return bound(6.0 * P * K, 4.0 * (3 * P + 3 * K + P))


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; count {torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def phase_build():
    from hybridquantization_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _cuda.build_info.get("log", "").splitlines() if "Used" in ln]
    print(f"build: {len(list(_cuda.CSRC.glob('*.cu')))} sources -> {_cuda._library_path().name} "
          f"in {secs:.2f} s; ptxas: {' | '.join(ptxas)}")


def phase_b1(img_dev, pals) -> tuple[dict, torch.Tensor]:
    """B1 against its plain version on the frame `img_dev` with `pals`."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    (h, w, _), (pop, k, _) = img_dev.shape, pals.shape
    feats = img_dev.reshape(-1, 3).contiguous()
    opps = cs.srgb_to_opp(pals).contiguous()
    opp, counts, idx = ak.assign_opp_usage_pop(feats, pals, opps, return_index=True)
    p_opp, _, p_idx = ak.assign_opp_usage_pop_reference(feats, pals, opps)
    torch.cuda.synchronize()
    if not bool((counts.sum(1) == h * w).all()):
        fail(f"B1 counts sum to {counts.sum(1).tolist()}, not {h * w}")
    for p in range(pop):
        if not torch.equal(counts[p].long(), torch.bincount(idx[p].long(), minlength=k)):
            fail(f"B1 counts of member {p} disagree with its indices")
    diff = idx != p_idx
    n_diff = int(diff.sum())
    max_gap = 0.0
    if n_diff:
        m, i = torch.nonzero(diff, as_tuple=True)
        f = feats[i].double()
        ca, cb = pals[m, idx[m, i].long()].double(), pals[m, p_idx[m, i].long()].double()
        gap = (f * ca).sum(-1) - 0.5 * (ca * ca).sum(-1) - (f * cb).sum(-1) + 0.5 * (cb * cb).sum(-1)
        max_gap = float(gap.abs().max())
        if max_gap > NEAR_TIE:
            fail(f"B1 index differs from the plain version off the near-tie class (gap {max_gap})")
    same = ~diff
    if not torch.equal(opp.transpose(1, 2)[same], p_opp.transpose(1, 2)[same]):
        fail("B1 opp differs from the plain version where the indices agree")
    max_abs = float((opp - p_opp).abs().max())
    ms = cuda_ms(lambda: ak.assign_opp_usage_pop(feats, pals, opps), 20)
    plain_ms = cuda_ms(lambda: ak.assign_opp_usage_pop_reference(feats, pals, opps), 3, warmup=1)
    print(f"B1 assign_pop {w}x{h} K={k} pop={pop}: {n_diff} of {pop * h * w} indices differ "
          f"(max score gap {max_gap:.3g} <= {NEAR_TIE}); opp equal where indices agree; "
          f"max |opp - plain| {max_abs:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"shape": f"{w}x{h}", "K": k, "pop": pop, "max_abs_err": max_abs,
            "index_mismatches": n_diff, "max_score_gap": max_gap, "ms": ms, "plain_ms": plain_ms,
            **b1_bound(h * w, k, pop)}, opp


def phase_b2(img, opp, dev) -> dict:
    """B2 against its plain version on the frame `img` with B1's `opp`."""
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters

    (h, w, _), pop = img.shape, opp.shape[0]
    ctx = _make_context(img, build_filters(), QuantizationConfig(), dev)
    q = opp.reshape(pop, 3, h, w)
    args = (q, ctx["target_planar"], ctx["kh"], ctx["kv"], cs.WHITEPOINT_D65, "CIE76")
    got = ff.fused_scielab_err_sums(*args)
    again = ff.fused_scielab_err_sums(*args)
    want = ff.fused_scielab_err_sums_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("B2 sums differ between two identical launches")
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (torch.isfinite(got).all() and rel <= B2_RTOL):
        fail(f"B2 sums {got.tolist()} vs plain {want.tolist()}: rel {rel}")
    ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args), 20)
    plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args), 3, warmup=1)
    max_abs = float((got - want).abs().max())
    print(f"B2 fused_fitness {w}x{h} pop={pop} CIE76 taps={ctx['kh'].shape[1]}: mean dE "
          f"{(got / (h * w)).tolist()}; max rel diff {rel:.3g} <= {B2_RTOL}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"shape": f"{w}x{h}", "pop": pop, "max_abs_err": max_abs, "max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, **b2_bound(h, w, ctx["kh"].shape[1], pop)}


def _b3_check(feats, pal) -> tuple[int, float, float]:
    """B3 against its plain version on the card: (index mismatches, largest
    absolute score gap among them, largest gap relative to max(1, |score|)).
    Fails when a mismatch lies outside the relative near-tie class."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    idx = ak.assign_idx(feats, pal)
    want = ak.assign_idx_reference(feats, pal)
    torch.cuda.synchronize()
    if int(idx.min()) < 0 or int(idx.max()) >= pal.shape[0]:
        fail(f"B3 index out of range: [{int(idx.min())}, {int(idx.max())}]")
    diff = idx != want
    n_diff = int(diff.sum())
    if not n_diff:
        return 0, 0.0, 0.0
    (i,) = torch.nonzero(diff, as_tuple=True)
    f = feats[i].double()
    ca, cb = pal[idx[i].long()].double(), pal[want[i].long()].double()
    sa = (f * ca).sum(-1) - 0.5 * (ca * ca).sum(-1)
    sb = (f * cb).sum(-1) - 0.5 * (cb * cb).sum(-1)
    gap = (sa - sb).abs()
    rel = gap / torch.maximum(sa.abs(), sb.abs()).clamp_min(1.0)
    if float(rel.max()) > NEAR_TIE_REL:
        fail(f"B3 index differs from the plain version off the near-tie class (rel gap {float(rel.max())})")
    return n_diff, float(gap.max()), float(rel.max())


def phase_b3(frames) -> list[dict]:
    """B3 against its plain version on one palette, at every shape the
    paths give it: each (label, H x W frame on the card, (K, 3) palette,
    histogram bits) in `frames` in sRGB and in LAB (quantize, the exact
    polish), and the bin centres of its colour histograms in sRGB (5 bits:
    the k-means seeding's 2^15 bins; 6 bits: the histogram polish's 2^18)."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops.kmeans import color_histogram

    cases = []
    for label, img_dev, pal, hist_bits in frames:
        px = img_dev.reshape(-1, 3).contiguous()
        cases.append((f"{label} srgb", px, pal))
        cases.append((f"{label} lab", cs.srgb_to_lab(px).contiguous(), cs.srgb_to_lab(pal).contiguous()))
        for bits in hist_bits:
            centers = color_histogram(px, bits)[1].contiguous()
            cases.append((f"{label} histogram 2^{3 * bits} bins srgb", centers, pal))
    out = []
    for label, feats, p in cases:
        n_diff, gap, rel = _b3_check(feats, p)
        ms = cuda_ms(lambda: ak.assign_idx(feats, p), 20)
        plain_ms = cuda_ms(lambda: ak.assign_idx_reference(feats, p), 3, warmup=1)
        print(f"B3 assign_idx {label} P={feats.shape[0]} K={p.shape[0]}: {n_diff} indices differ "
              f"(max score gap {gap:.3g}, relative {rel:.3g} <= {NEAR_TIE_REL}); "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        out.append({"case": label, "P": feats.shape[0], "K": p.shape[0], "max_abs_err": gap,
                    "max_rel_gap": rel, "index_mismatches": n_diff, "ms": ms, "plain_ms": plain_ms,
                    **b3_bound(feats.shape[0], p.shape[0])})
    return out


def phase_small_polish(dev) -> None:
    """Ten exact Lloyd steps on a small input, card (B3) against the CPU
    (plain version), from the same palette."""
    from hybridquantization_tpu_torch.ops import assign as assign_ops
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.synth import natural_image

    px = torch.as_tensor(natural_image(96, 128, seed=7)).reshape(-1, 3)
    pal = torch.rand((8, 3), generator=torch.Generator().manual_seed(12))
    before = ak.assign_idx.launches
    got = assign_ops.lloyd_polish(px.to(dev), pal.to(dev), POLISH).cpu()
    launches = ak.assign_idx.launches - before
    want = assign_ops.lloyd_polish(px, pal, POLISH)
    err = float((got - want).abs().max())
    if launches != POLISH or not err <= POLISH_ATOL:
        fail(f"small polish: {launches} B3 launches, max |palette diff| {err}")
    print(f"polish 128x96 K=8, {POLISH} exact Lloyd steps, card (B3, {launches} launches) vs "
          f"plain path: max |palette diff| {err:.3g} <= {POLISH_ATOL}")


def _counts() -> dict:
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff

    return {"assign_pop": ak.assign_opp_usage_pop.launches,
            "fused_fitness": ff.fused_scielab_err_sums.launches,
            "assign_idx": ak.assign_idx.launches}


def _reset_counts() -> None:
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff

    ak.assign_opp_usage_pop.launches = 0
    ff.fused_scielab_err_sums.launches = 0
    ak.assign_idx.launches = 0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _run_schedule(img, dev, cfg):
    """The quality-matched flow at full width, its launch counts checked:
    k-means seeds, imax=QS_IMAX SWASA iterations, POLISH Lloyd polish steps
    (the histogram path at 4K), quantize, error_image. Returns (engine,
    run info, launches, mean S-CIELAB dE, colours, stage seconds)."""
    from hybridquantization_tpu_torch import HybridQuantizer

    _reset_counts()

    def run():
        q = HybridQuantizer(cfg, device=dev)
        return q, q.run(img)[1]

    (q, info), t_run = _timed(run)
    palette, t_polish = _timed(lambda: q.polish(img, info["palette"], POLISH))
    out, t_quant = _timed(lambda: q.quantize(img, palette))
    (mean, viz), t_err = _timed(lambda: q.error_image(img, out))
    launches = _counts()
    want = {"assign_pop": 1 + QS_IMAX, "fused_fitness": 1 + QS_IMAX,
            "assign_idx": SEED_STEPS + 1 + POLISH + 1}
    if launches != want:
        fail(f"the schedule launched {launches}, not {want}")
    n_colors = len(torch.unique(out.reshape(-1, 3), dim=0))
    if not (torch.isfinite(mean) and bool(torch.isfinite(out).all())) or n_colors > K:
        fail(f"quality schedule: mean dE {float(mean)}, {n_colors} colours")
    if out.shape != (H, W, 3) or viz.shape != (H, W, 3):
        fail(f"quality schedule output {tuple(out.shape)}")
    secs = {"run": t_run, "polish": t_polish, "quantize": t_quant, "error_image": t_err,
            "e2e": t_run + t_polish + t_quant + t_err}
    return q, info, launches, float(mean), n_colors, secs


def phase_quality_schedule(img, dev, random_de: float) -> tuple[dict, dict]:
    """The flow bench.py times, at 4K/K256/pop4: k-means seeds, 50 SWASA
    iterations, 10 Lloyd polish steps (the histogram path at 4K), quantize,
    error_image; then the exact polish at 4K. B3 runs in every Lloyd step
    of the seeding and the polish and in both quantize passes (the run's
    own and the final one)."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.ops import assign as assign_ops
    from hybridquantization_tpu_torch.ops.kmeans import kmeans_init_palettes
    from hybridquantization_tpu_torch.pipeline import _make_context

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX),
                             init="kmeans")
    q, info, launches, mean, n_colors, secs = _run_schedule(img, dev, cfg)
    # the split of the run (warm repeats of its stages, each synchronized)
    img_dev = torch.as_tensor(img, device=dev)
    _, t_ctx = _timed(lambda: _make_context(img_dev, q.filters, cfg, dev))
    _, t_seed = _timed(lambda: kmeans_init_palettes(
        torch.Generator(device=dev).manual_seed(0), img_dev.reshape(-1, 3), K, POP))

    _reset_counts()
    exact, t_exact = _timed(lambda: assign_ops.polish_palette(
        img_dev.reshape(-1, 3), info["palette"], "srgb", q._whitepoint, POLISH, method="exact"))
    exact_launches = _counts()
    b3 = exact_launches["assign_idx"]
    if b3 != POLISH:
        fail(f"assign_idx launched {b3} times in the exact polish, not {POLISH}")
    if not (bool(torch.isfinite(exact).all()) and float(exact.min()) >= 0 and float(exact.max()) <= 1):
        fail(f"exact polish palette out of range: [{float(exact.min())}, {float(exact.max())}]")
    mean_exact, _ = q.error_image(img, q.quantize(img, exact))
    print(f"quality schedule {W}x{H} K={K} pop={POP} kmeans + imax={QS_IMAX} + {POLISH} hist "
          f"polish: {secs['e2e']:.3f} s end to end (run {secs['run']:.3f} s of which anneal "
          f"{info['seconds']:.3f} s; polish {secs['polish']:.3f} s, quantize {secs['quantize']:.3f} s, "
          f"error_image {secs['error_image']:.3f} s; warm repeats: context {t_ctx:.3f} s, k-means seeding "
          f"{t_seed:.3f} s); best fitness {info['best_error']:.5f}, mean S-CIELAB dE "
          f"{mean:.5f} (random init imax={IMAX}: {random_de:.5f}), {n_colors} colours; "
          f"launches {launches}; exact polish {t_exact:.3f} s, B3 launched {b3} times, dE after "
          f"exact polish {float(mean_exact):.5f} vs hist polish {mean:.5f}")
    return launches, exact_launches


def phase_fast_schedule(img, dev) -> dict:
    """The quality schedule with precision="bf16", tie_mode="average" (what
    `quantize --fast` runs: B1 and B2 in their fast variants, B3 fp32 as in
    every mode), beside the exact schedule's seconds and dE: both warm (the
    quality schedule paid the first calls), in turns exact, fast, fast,
    exact. The launches returned are the last fast run's."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    base = {"swasa": SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX), "init": "kmeans"}
    cfgs = {"exact": QuantizationConfig(**base),
            "fast": QuantizationConfig(**base, precision="bf16", tie_mode="average")}
    runs = {"exact": [], "fast": []}
    for mode in ("exact", "fast", "fast", "exact"):
        runs[mode].append(_run_schedule(img, dev, cfgs[mode])[1:])
    info, launches, mean, n_colors, _ = runs["fast"][-1]
    einfo, _, emean, _, _ = runs["exact"][-1]
    e2e = {m: ", ".join(f"{r[4]['e2e']:.3f}" for r in rs) for m, rs in runs.items()}
    anneal = {m: ", ".join(f"{r[0]['seconds']:.3f}" for r in rs) for m, rs in runs.items()}
    best, ebest = info["telemetry"]["best_error"], einfo["telemetry"]["best_error"]
    # how many entries of the best palette win no pixel, with each score
    unused = {}
    feats = torch.as_tensor(img, device=dev).reshape(-1, 3)
    pal = info["palette"][None].contiguous()
    for precision, tie_mode in (("f32x3", "first"), ("bf16", "average")):
        counts = ak.assign_opp_usage_pop(feats, pal, cs.srgb_to_opp(pal).contiguous(),
                                         precision=precision, tie_mode=tie_mode)[1]
        unused[precision] = int((counts == 0).sum())
    print(f"fast schedule {W}x{H} K={K} pop={POP} bf16 + average, kmeans + imax={QS_IMAX} + "
          f"{POLISH} hist polish, warm, in turns exact/fast/fast/exact: fast {e2e['fast']} s end to "
          f"end (anneal {anneal['fast']} s) vs exact {e2e['exact']} s (anneal {anneal['exact']} s); "
          f"best fitness {best[0]:.5f} after iteration 1, {info['best_error']:.5f} after {QS_IMAX} "
          f"(exact {ebest[0]:.5f}, {ebest[-1]:.5f}), mean S-CIELAB dE {mean:.5f} vs exact {emean:.5f} "
          f"({100 * (mean / emean - 1):+.2f}%), {n_colors} colours; launches {launches}; "
          f"its best palette leaves {unused['bf16']} of {K} entries without a pixel with bf16 scores, "
          f"{unused['f32x3']} with fp32")
    return launches


def phase_cli(dev) -> dict:
    """The quantize CLI with every flag of the flow on a 1024x768 .ppm (under
    2^20 pixels, so polish takes the exact path through B3), a second run
    that resumes from its checkpoint, and `error` on the two files."""
    from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig
    from hybridquantization_tpu_torch import cli
    from hybridquantization_tpu_torch import io as hio
    from hybridquantization_tpu_torch.synth import natural_image

    with tempfile.TemporaryDirectory() as tmp:
        src, dst, ck, err, pal, e2 = (os.path.join(tmp, n) for n in (
            "in.ppm", "out.ppm", "ck.npz", "err.ppm", "pal.npy", "e.ppm"))
        hio.save_image(src, natural_image(CLI_H, CLI_W, seed=3))
        argv = ["quantize", src, dst, "-k", str(CLI_K), "--imax", str(CLI_IMAX), "--init", "kmeans",
                "--polish", str(POLISH), "--dither", "0.5", "--checkpoint", ck,
                "--checkpoint-every", "20", "--error-image", err, "--palette-out", pal]

        def run(args):
            _reset_counts()
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = cli.main(args)
            torch.cuda.synchronize()
            if rc != 0:
                fail(f"cli {args[0]} exited {rc}: {text.getvalue()[-2000:]}")
            return text.getvalue(), _counts(), time.perf_counter() - t0

        text, first, secs = run(argv)
        for path in (dst, ck, err, pal):
            if not os.path.exists(path):
                fail(f"cli quantize wrote no {os.path.basename(path)}")
        out = hio.load_image(dst)
        n_colors = len(np.unique(out.reshape(-1, 3), axis=0))
        if out.shape != (CLI_H, CLI_W, 3) or n_colors > CLI_K or np.load(pal).shape != (CLI_K, 3):
            fail(f"cli output {out.shape} with {n_colors} colours")
        # B3: the k-means seeding's Lloyd steps, the exact polish, the dithered quantize
        want = {"assign_pop": 1 + CLI_IMAX, "fused_fitness": 1 + CLI_IMAX,
                "assign_idx": SEED_STEPS + POLISH + 1}
        if first != want:
            fail(f"cli quantize launched {first}, not {want}")
        quant_de = float(re.findall(r"DeltaE : (\S+)", text)[-1])

        text2, second, _ = run(argv)
        if "resuming from" not in text2 or f"at iteration {CLI_IMAX}" not in text2:
            fail(f"cli second run did not resume at iteration {CLI_IMAX}: {text2[-500:]}")
        # no seeding and no iteration: B3 only in the polish and the quantize
        want = {"assign_pop": 0, "fused_fitness": 0, "assign_idx": POLISH + 1}
        if second != want:
            fail(f"cli resumed run launched {second}, not {want}")

        text3, _, _ = run(["error", src, dst, "--out", e2])
        cli_de = float(re.findall(r"DeltaE : (\S+)", text3)[-1])
        want, _ = HybridQuantizer(QuantizationConfig(), device=dev).error_image(
            hio.load_image(src), hio.load_image(dst))
        if abs(cli_de - float(want)) > CLI_DE_RTOL * abs(float(want)):
            fail(f"cli error printed dE {cli_de}, error_image gives {float(want)}")
    print(f"cli quantize {CLI_W}x{CLI_H} -k {CLI_K} --imax {CLI_IMAX} --init kmeans --polish "
          f"{POLISH} --dither 0.5 --checkpoint: {secs:.3f} s, {n_colors} colours, dE "
          f"{quant_de:.5f} (float output); launches {first} (B3: {SEED_STEPS} seeding steps + "
          f"{POLISH} exact polish steps + 1 quantize); resumed run launches {second}; cli error dE {cli_de:.6f} = "
          f"error_image {float(want):.6f} on the 8-bit files")
    return first


def _near_tie_gaps(feats, pal, mism) -> torch.Tensor:
    """Relative f64 gap between the two best distinct-valued entries of each
    (member, pixel) in `mism`, over max(1, |score|): the f32 near-tie class."""
    m, i = torch.nonzero(mism, as_tuple=True)
    gaps, step = [], 1 << 14
    for lo in range(0, m.numel(), step):
        f = feats[i[lo:lo + step]].double()
        c = pal[m[lo:lo + step]].double()  # (n, K, 3)
        s = (f[:, None, :] * c).sum(-1) - 0.5 * (c * c).sum(-1)
        top = torch.topk(s, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1.0))
    return torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)


def phase_fast_kernels(img, img_dev, pals, dev) -> tuple[list, list]:
    """B1's fast variants ((first, bf16), (average, f32), (average, bf16)) in
    sRGB and LAB and B2 bf16 at 4K/K256/pop4 on the natural frame, each
    against its plain version and timed beside the exact kernel. The plain
    version repeats every bf16 score bit for bit, so the bf16 variants must
    agree everywhere: indices (first of the maximum), counts (pixels or
    hits) and colours. (average, f32) may differ only on f32 near ties."""
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters

    (h, w, _), (pop, k, _) = img_dev.shape, pals.shape
    opps = cs.srgb_to_opp(pals).contiguous()
    b1 = []
    for space in ("srgb", "lab"):
        feats, pf = img_dev.reshape(-1, 3), pals
        if space == "lab":
            feats, pf = cs.srgb_to_lab(feats), cs.srgb_to_lab(pals)
        feats, pf = feats.contiguous(), pf.contiguous()
        exact_ms = cuda_ms(lambda: ak.assign_opp_usage_pop(feats, pf, opps), 20)
        for precision, tie_mode in (("bf16", "first"), ("f32x3", "average"), ("bf16", "average")):
            kw = {"precision": precision, "tie_mode": tie_mode}
            opp, counts, idx = ak.assign_opp_usage_pop(feats, pf, opps, return_index=True, **kw)
            p_opp, p_counts, p_idx = ak.assign_opp_usage_pop_reference(feats, pf, opps, **kw)
            torch.cuda.synchronize()
            mism = (idx != p_idx) | (opp != p_opp).any(1)
            n_diff = int(mism.sum())
            count_diff = int((counts - p_counts).abs().sum())
            total = counts.sum(-1)
            if tie_mode == "first" and not bool((total == h * w).all()):
                fail(f"B1 {space} {kw}: counts sum to {total.tolist()}, not {h * w}")
            if tie_mode == "average" and not bool((total >= h * w).all()):
                fail(f"B1 {space} {kw}: hits sum to {total.tolist()}, below {h * w}")
            gap = 0.0
            if precision == "bf16" and (n_diff or count_diff):
                m, i = torch.nonzero(mism, as_tuple=True)
                fail(f"B1 {space} {kw}: {n_diff} pixels and {count_diff} counts differ from the plain "
                     f"version, which repeats every bf16 score; first at member {m[:3].tolist()}, pixel "
                     f"{i[:3].tolist()}: kernel index {idx[m[:3], i[:3]].tolist()}, plain "
                     f"{p_idx[m[:3], i[:3]].tolist()}")
            if n_diff:
                gap = float(_near_tie_gaps(feats, pf, mism).max())
                if gap > NEAR_TIE_REL:
                    fail(f"B1 {space} {kw}: {n_diff} pixels differ off the near-tie class (gap {gap})")
            max_abs = float((opp - p_opp).abs().max())
            ms = cuda_ms(lambda: ak.assign_opp_usage_pop(feats, pf, opps, **kw), 20)
            plain_ms = cuda_ms(lambda: ak.assign_opp_usage_pop_reference(feats, pf, opps, **kw), 2, warmup=1)
            print(f"B1 fast {space} {precision} {tie_mode} {w}x{h} K={k} pop={pop}: {n_diff} of "
                  f"{pop * h * w} pixels differ from the plain version (relative gap {gap:.3g} <= "
                  f"{NEAR_TIE_REL}), {count_diff} counts; max |opp - plain| {max_abs:.3g}; kernel "
                  f"{ms:.3f} ms (exact {exact_ms:.3f} ms), plain {plain_ms:.3f} ms")
            b1.append({"variant": f"{space} {precision} {tie_mode}", "shape": f"{w}x{h}", "K": k,
                       "pop": pop, "max_abs_err": max_abs, "index_mismatches": n_diff,
                       "count_mismatches": count_diff, "max_rel_gap": gap, "ms": ms,
                       "exact_ms": exact_ms, "plain_ms": plain_ms,
                       **b1_bound(h * w, k, pop, bf16=precision == "bf16")})

    ctx = _make_context(img, build_filters(), QuantizationConfig(), dev)
    q = ak.assign_opp_usage_pop(img_dev.reshape(-1, 3).contiguous(), pals, opps)[0].reshape(pop, 3, h, w)
    args = (q, ctx["target_planar"], ctx["kh"], ctx["kv"], cs.WHITEPOINT_D65, "CIE76")
    got = ff.fused_scielab_err_sums(*args, precision="bf16")
    again = ff.fused_scielab_err_sums(*args, precision="bf16")
    want = ff.fused_scielab_err_sums_reference(*args, precision="bf16")
    exact = ff.fused_scielab_err_sums(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("B2 bf16 sums differ between two identical launches")
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (torch.isfinite(got).all() and rel <= B2_RTOL):
        fail(f"B2 bf16 sums {got.tolist()} vs plain {want.tolist()}: rel {rel}")
    vs_exact = ((got.double() - exact.double()).abs() / exact.double().abs()).max().item()
    ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, precision="bf16"), 20)
    exact_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args), 20)
    plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args, precision="bf16"), 3, warmup=1)
    taps = ctx["kh"].shape[1]
    print(f"B2 fast bf16 {w}x{h} pop={pop}: max rel diff from the plain version {rel:.3g} <= {B2_RTOL}; "
          f"from fp32 {vs_exact:.3g}; kernel {ms:.3f} ms (exact {exact_ms:.3f} ms), plain {plain_ms:.3f} ms")
    b2 = [{"variant": "bf16", "shape": f"{w}x{h}", "pop": pop, "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": rel, "rel_from_fp32": vs_exact, "ms": ms, "exact_ms": exact_ms,
           "plain_ms": plain_ms, **b2_bound(h, w, taps, pop, bf16=True)}]
    return b1, b2


def _bucket_kernels(ctx, pals, palette, cfg) -> dict:
    """One bucket's image-axis launches of B1 and B2 in the variants
    `quantize-batch --fast` runs them (bf16 + average; bf16) against their
    plain versions on the same (B, P, 3) features and (B, pop, K, 3)
    palettes (B1: zero index, count and colour mismatches, as in
    phase_fast_kernels; B2 within B2_RTOL), and B3 on the bucket's first
    image with its final palette (quantize's lookup; the relative near-tie
    class); each timed beside its plain version (one plain call)."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _features

    feats = ctx["assign_pixels"]
    (n, P, _), (_, pop, k, _) = feats.shape, pals.shape
    h, w = ctx["target_lab"].shape[1:3]
    bucket = f"{w}x{h}"
    pf = _features(pals, cfg, ctx["whitepoint"]).contiguous()
    opps = cs.srgb_to_opp(pals).contiguous()
    kw = {"precision": cfg.precision, "tie_mode": cfg.tie_mode}
    opp, counts, idx = ak.assign_opp_usage_pop(feats, pf, opps, return_index=True, **kw)
    (p_opp, p_counts, p_idx), t_b1 = _timed(
        lambda: ak.assign_opp_usage_pop_reference(feats, pf, opps, **kw))
    n_diff = int(((idx != p_idx) | (opp != p_opp).any(-2)).sum())
    count_diff = int((counts - p_counts).abs().sum())
    if n_diff or count_diff or not bool((counts.sum(-1) >= P).all()):
        fail(f"B1 {kw} bucket {bucket} x{n}: {n_diff} pixels and {count_diff} counts differ from "
             f"the plain version on the image axis; hits {counts.sum(-1).min().item()} (>= {P})")
    b1_abs = float((opp - p_opp).abs().max())
    del p_opp, p_counts, p_idx, counts, idx
    b1_ms = cuda_ms(lambda: ak.assign_opp_usage_pop(feats, pf, opps, **kw), 5)

    conv = cfg.conv_precision or cfg.precision
    args = (opp.reshape(n, pop, 3, h, w), ctx["target_planar"], ctx["kh"], ctx["kv"],
            ctx["whitepoint"], cfg.deltaE)
    got = ff.fused_scielab_err_sums(*args, precision=conv)
    want, t_b2 = _timed(lambda: ff.fused_scielab_err_sums_reference(*args, precision=conv))
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (bool(torch.isfinite(got).all()) and rel <= B2_RTOL):
        fail(f"B2 {conv} bucket {bucket} x{n}: rel {rel} from the plain version on the image axis")
    b2_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, precision=conv), 5)
    b2_abs = float((got - want).abs().max())
    del opp, args

    f0 = feats[0].contiguous()
    n3, gap, rel3 = _b3_check(f0, palette)
    b3_ms = cuda_ms(lambda: ak.assign_idx(f0, palette), 20)
    b3_plain = cuda_ms(lambda: ak.assign_idx_reference(f0, palette), 3, warmup=1)
    print(f"batch bucket {bucket} x{n} against the plain versions: B1 {kw['precision']} "
          f"{kw['tie_mode']} image axis 0 index/colour and 0 count mismatches, kernel {b1_ms:.3f} ms, "
          f"plain {t_b1 * 1e3:.3f} ms; B2 {conv} image axis max rel diff {rel:.3g} <= {B2_RTOL}, kernel "
          f"{b2_ms:.3f} ms, plain {t_b2 * 1e3:.3f} ms; B3 image 0 K={k}: {n3} indices differ "
          f"(relative gap {rel3:.3g} <= {NEAR_TIE_REL}), kernel {b3_ms:.3f} ms, plain {b3_plain:.3f} ms")
    row = {"bucket": bucket, "images": n, "bucket_pixels": n * P}
    return {
        "assign_pop": {**row, "variant": f"srgb {kw['precision']} {kw['tie_mode']}", "K": k, "pop": pop,
                       "max_abs_err": b1_abs, "index_mismatches": n_diff, "count_mismatches": count_diff,
                       "ms": b1_ms, "plain_ms": t_b1 * 1e3, **b1_bound(P, k, pop, bf16=True, images=n)},
        "fused_fitness": {**row, "variant": conv, "pop": pop, "max_abs_err": b2_abs, "max_rel_err": rel,
                          "ms": b2_ms, "plain_ms": t_b2 * 1e3,
                          **b2_bound(h, w, ctx["kh"].shape[1], pop, bf16=True, images=n)},
        "assign_idx": {**row, "case": "image 0 srgb", "P": P, "K": k, "max_abs_err": gap,
                       "max_rel_gap": rel3, "index_mismatches": n3, "ms": b3_ms, "plain_ms": b3_plain,
                       **b3_bound(P, k)},
    }


def _write_ppm(job) -> str:
    """Write one synthetic input (path, height, width, seed); a worker of
    the batch phase's process pool."""
    from hybridquantization_tpu_torch import io as hio
    from hybridquantization_tpu_torch.synth import natural_image

    path, h, w, seed = job
    hio.save_image(path, natural_image(h, w, seed=seed))
    return path


def phase_batch(dev) -> dict:
    """quantize-batch --fast --init kmeans --imax 50 --polish 10
    --error-images at K=256, pop 4 over 64 PPMs (module doc): the 64 through
    the command's engine and bucketing, then the command on four of them."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig, cli, native
    from hybridquantization_tpu_torch import io as hio
    from hybridquantization_tpu_torch.batching import run_bucketed
    from hybridquantization_tpu_torch.parallel import BatchQuantizer
    from hybridquantization_tpu_torch.pipeline import (
        _make_batch_context, _make_context, make_population_fitness)

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX),
                             init="kmeans", precision="bf16", tie_mode="average")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(os.path.join(tmp, f"im{i:02d}_{w}x{h}.ppm"), h, w, i)
                for i, (h, w) in ((i, BATCH_SIZES[i % 4]) for i in range(BATCH_IMAGES))]
        t0 = time.perf_counter()
        workers = min(8, os.cpu_count() or 1)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            paths = list(ex.map(_write_ppm, jobs))
        t_gen = time.perf_counter() - t0
        images = [native.load_image(p) for p in paths]

        engine = BatchQuantizer(cfg, device=dev)
        buckets = []

        def run_batch(stack):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t = time.perf_counter()
            out, info = engine.run(stack, polish_iters=POLISH)
            de, viz = engine.error_images(stack, out)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches = _counts()
            peak = torch.cuda.max_memory_allocated()
            n, h, w, _ = stack.shape
            want = {"assign_pop": 1 + QS_IMAX, "fused_fitness": 1 + QS_IMAX,
                    "assign_idx": n * B3_PER_IMAGE}
            if launches != want:
                fail(f"batch bucket {w}x{h} of {n} launched {launches}, not {want}")
            colours = max(len(torch.unique(o.reshape(-1, 3), dim=0)) for o in out)
            if not (bool(torch.isfinite(de).all()) and bool(torch.isfinite(out).all())) or colours > K:
                fail(f"batch bucket {w}x{h}: dE {de.tolist()}, {colours} colours")
            print(f"batch bucket {w}x{h} x{n}: {secs:.3f} s, {n * h * w / secs / 1e6:.2f} Mpix/s, "
                  f"mean dE {float(de.mean()):.5f}, launches {launches} (B1/B2 1 + imax per bucket), "
                  f"peak {peak / 2**30:.2f} GiB")
            # the bucket's batched fitness against each image's own, on the
            # final populations, then each kernel at the bucket's shapes
            # against its plain version (these launches come after the count)
            t_check = time.perf_counter()
            pals = info["state"].colors
            bctx = _make_batch_context(stack, engine.filters, cfg, dev)
            err, use = make_population_fitness(bctx, cfg)(pals)
            for i in range(n):
                e, u = make_population_fitness(_make_context(stack[i], engine.filters, cfg, dev), cfg)(pals[i])
                if not (torch.equal(err[i], e) and torch.equal(use[i], u)):
                    fail(f"batch bucket {w}x{h}: image {i}'s batched fitness differs from its own")
            print(f"batch bucket {w}x{h} x{n}: batched fitness bit-equal to each image's own")
            rows = _bucket_kernels(bctx, pals, info["palettes"][0], cfg)
            for name_, row in rows.items():
                row["launches"] = launches[name_]
            for name_ in ("assign_pop", "fused_fitness"):
                rows[name_]["batched_bit_equal"] = True
            del bctx
            check_secs.append(time.perf_counter() - t_check)
            buckets.append({"shape": f"{w}x{h}", "images": n, "seconds": secs,
                            "mpix_per_s": n * h * w / secs / 1e6, "mean_de": float(de.mean()),
                            "launches": launches, "peak_gib": peak / 2**30, "kernels": rows})
            return out.cpu().numpy(), info["best_errors"], de.cpu().numpy()

        # the 64 images' seconds: run_bucketed's, less each bucket's checks
        # against the plain versions (run after its count)
        check_secs = []
        t0 = time.perf_counter()
        results = run_bucketed(images, run_batch)
        t_all = time.perf_counter() - t0 - sum(check_secs)
        total_pix = sum(im.shape[0] * im.shape[1] for im in images)
        for im, res in zip(images, results):
            if res[0].shape != im.shape:
                fail(f"batch output {res[0].shape} for an input of {im.shape}")

        # the command itself on one file of each resolution (images 0-3,
        # each the first of its bucket above, so with the same seed)
        out_dir, err_dir = os.path.join(tmp, "out"), os.path.join(tmp, "err")
        argv = ["quantize-batch", *paths[:4], "--out-dir", out_dir, "--fast", "--init", "kmeans",
                "-k", str(K), "--population", str(POP), "--imax", str(QS_IMAX),
                "--polish", str(POLISH), "--error-images", err_dir]
        _reset_counts()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        cli_launches = _counts()
        want = {"assign_pop": 4 * (1 + QS_IMAX), "fused_fitness": 4 * (1 + QS_IMAX),
                "assign_idx": 4 * B3_PER_IMAGE}
        if rc != 0 or cli_launches != want:
            fail(f"quantize-batch exited {rc}, launched {cli_launches}, not {want}: {text.getvalue()[-2000:]}")
        lines = [ln for ln in text.getvalue().splitlines() if "error=" in ln and "DeltaE=" in ln]
        done = re.findall(r"batch done: .*", text.getvalue())
        if len(lines) != 4 or not done:
            fail(f"quantize-batch printed {text.getvalue()[-2000:]}")
        for i, p in enumerate(paths[:4]):
            name = os.path.splitext(os.path.basename(p))[0]
            got = hio.load_image(os.path.join(out_dir, f"{name}_q{K}.png"))
            want_u8 = np.clip(results[i][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            if not np.array_equal((got * 255.0 + 0.5).astype(np.uint8), want_u8):
                fail(f"quantize-batch output for {name} differs from the engine's run of its bucket")
            if hio.load_image(os.path.join(err_dir, f"{name}_DE.png")).shape != got.shape:
                fail(f"quantize-batch error image for {name}")
    print(f"batch {BATCH_IMAGES} images ({total_pix / 1e6:.1f} Mpix, {len(buckets)} buckets) --fast K={K} "
          f"pop={POP} kmeans imax={QS_IMAX} polish {POLISH} + error images: {t_all:.3f} s, "
          f"{total_pix / t_all / 1e6:.2f} Mpix/s, {total_pix * QS_IMAX * POP / t_all / 1e6:.0f} "
          f"Mpix-evals/s (checks against the plain versions, {sum(check_secs):.1f} s, left out; "
          f"inputs made in {t_gen:.1f} s on {workers} processes); cli on 4 files "
          f"(one per size): {t_cli:.3f} s, launches {cli_launches}, outputs equal to the engine's; "
          f"{done[0]}")
    return {"buckets": buckets, "seconds": t_all, "cli_launches": cli_launches,
            "launches": {name: sum(b["launches"][name] for b in buckets) for name in buckets[0]["launches"]}}


def phase_small_slice(dev) -> None:
    """Ten annealing steps on a small input, card (kernels) against the CPU
    (plain versions), fed the same initial palettes and draws."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import loop, schedule
    from hybridquantization_tpu_torch.synth import natural_image

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=4, imax=10))
    img = natural_image(96, 128, seed=7)
    g = torch.Generator().manual_seed(11)
    init = schedule.random_palettes(g, 4, 8)
    states, steps = {}, {}
    for d in ("cpu", dev):
        fit = make_population_fitness(_make_context(img, build_filters(), cfg, d), cfg)
        states[d] = loop.init_state(torch.Generator(device=d), fit, cfg.swasa, init.to(d))
        steps[d] = loop.make_step(fit, cfg.swasa)
    worst = 0.0
    for ite in range(1, 11):
        draws = schedule.draw_step(g, 4, 8)
        for d in ("cpu", dev):
            states[d], _ = steps[d](
                states[d], torch.tensor(ite, dtype=torch.int32, device=d),
                {k: v.to(d) for k, v in draws.items()},
            )
        worst = max(worst, float((states[dev].current_errors.cpu() - states["cpu"].current_errors).abs().max()))
    if worst > SMALL_ATOL or not torch.allclose(states[dev].colors.cpu(), states["cpu"].colors, atol=1e-5):
        fail(f"10-step slice on the card departs from the plain path (max |error diff| {worst})")
    print(f"slice 128x96 K=8 pop=4, 10 steps, card vs plain path on the same draws: "
          f"max |error diff| {worst:.3g} <= {SMALL_ATOL}; best {float(states[dev].best_error):.5f}")


def phase_e2e(img, dev) -> tuple[dict, float]:
    from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=IMAX))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    q = HybridQuantizer(cfg, device=dev)
    out, info = q.run(img)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = _counts()
    for name in ("assign_pop", "fused_fitness"):
        if launches[name] != 1 + IMAX:
            fail(f"{name} launched {launches[name]} times in the run, not 1 + imax = {1 + IMAX}")
    mean, viz = q.error_image(img, out)
    torch.cuda.synchronize()
    n_colors = len(torch.unique(out.reshape(-1, 3), dim=0))
    best = info["telemetry"]["best_error"]
    if not (torch.isfinite(mean) and bool(torch.isfinite(out).all())):
        fail("non-finite output or error")
    if out.shape != (H, W, 3) or viz.shape != (H, W, 3) or n_colors > K:
        fail(f"output {tuple(out.shape)} with {n_colors} colours")
    if not np.all(np.diff(best) <= 0) or len(best) != IMAX:
        fail(f"best_error trajectory {best.tolist()}")
    print(f"e2e {W}x{H} K={K} pop={POP} imax={IMAX}: {info['seconds'] / IMAX:.4f} s/iter, "
          f"{e2e:.3f} s end to end (context, init, search, quantize), best fitness "
          f"{info['best_error']:.5f}, mean S-CIELAB dE {float(mean):.5f}, {n_colors} colours, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    return launches, float(mean)


def main() -> int:
    name, smi = phase_device()
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.synth import natural_image

    dev = setup_device("cuda")
    phase_build()
    t0 = time.perf_counter()
    img = natural_image(H, W, seed=0)
    print(f"input: natural_image {W}x{H} seed 0 in {time.perf_counter() - t0:.1f} s (host)")
    img_dev = torch.as_tensor(img, device=dev)
    pals = torch.rand((POP, K, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    cli_img = natural_image(CLI_H, CLI_W, seed=3)  # the cli phase's input
    cli_dev = torch.as_tensor(cli_img, device=dev)
    cli_pals = torch.rand((POP, CLI_K, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    b1, opp = phase_b1(img_dev, pals)
    b1_cli, cli_opp = phase_b1(cli_dev, cli_pals)
    b2 = phase_b2(img, opp, dev)
    b2_cli = phase_b2(cli_img, cli_opp, dev)
    # the cli frame is under 2^20 pixels: its polish is exact, only its seeding bins
    b3 = phase_b3([(f"{W}x{H}", img_dev, pals[0].contiguous(), (5, 6)),
                   (f"{CLI_W}x{CLI_H}", cli_dev, cli_pals[0].contiguous(), (5,))])
    del opp, cli_opp, cli_dev
    b1_fast, b2_fast = phase_fast_kernels(img, img_dev, pals, dev)
    del img_dev
    torch.cuda.empty_cache()
    phase_small_slice(dev)
    phase_small_polish(dev)
    launches, random_de = phase_e2e(img, dev)
    quality, exact = phase_quality_schedule(img, dev, random_de)
    cli_counts = phase_cli(dev)
    fast = phase_fast_schedule(img, dev)
    del img
    torch.cuda.empty_cache()
    batch = phase_batch(dev)
    # each kernel: at top level, its check and times at the largest bucket of
    # this slice's main path (quantize-batch --fast over the 64 images) and
    # `launches` from that path; every bucket under "main_path"; the 4K
    # variants under "variants", each with the launches of the 4K path that
    # runs it ("launches_from"; 0 where no path does); the other shapes
    # under "checks"; every path's own counts under "launches_by_path"
    runs_at_4k = {"srgb f32x3 first": "quality_schedule", "f32x3": "quality_schedule",
                  "srgb bf16 average": "fast_schedule", "bf16": "fast_schedule"}
    path_counts = {"quality_schedule": quality, "fast_schedule": fast}

    def at_4k(name_, v):
        path = runs_at_4k.get(v["variant"])
        return {"launches_from": path, "launches": path_counts[path][name_] if path else 0}

    kernels = []
    for name_, source, replaces, variants, checks in (
        ("assign_pop", "csrc/assign_pop.cu", "ops/pallas_assign.py:371",
         [{"variant": "srgb f32x3 first", **b1}, *b1_fast], [b1_cli]),
        ("fused_fitness", "csrc/fused_fitness.cu", "ops/fused_fitness.py:597",
         [{"variant": "f32x3", **b2}, *b2_fast], [b2_cli]),
        ("assign_idx", "csrc/assign_idx.cu", "ops/pallas_assign.py:420", [], b3),
    ):
        common = {"name": name_, "route": "cuda",
                  "source": f"hybridquantization_tpu_torch/{source}",
                  "replaces": f"hybridquantization_tpu/{replaces}"}
        main_path = [b["kernels"][name_] for b in batch["buckets"]]
        largest = max(main_path, key=lambda r: r["bucket_pixels"])
        kernels.append({
            **common, **largest, "launches": batch["launches"][name_], "main_path": main_path,
            "variants": [{**common, **v, **at_4k(name_, v)} for v in variants],
            "checks": checks,
            "launches_by_path": {"e2e_random_imax30": launches[name_],
                                 "quality_schedule": quality[name_],
                                 "exact_polish_4k": exact[name_],
                                 "cli_quantize": cli_counts[name_],
                                 "fast_schedule": fast[name_],
                                 "quantize_batch_64": batch["launches"][name_],
                                 "cli_quantize_batch_4": batch["cli_launches"][name_]},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
