#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`hybridquantization_tpu_torch/csrc/` (one nvcc per source, in parallel),
holds each against its plain torch version at the shapes the paths below
give it (B1 and B2: a 3840x2160 frame at K=256 and a 1024x768 frame at
K=64, population 4; B3's index and Lloyd-step modes, each a batch of
problems in one launch: the k-means seeding's 2^15-bin histograms (one
image x 4 members, a bucket of 16 images x 4 members), a 1080p bucket's
2^18-bin histogram polish, a 720p bucket's exact polish, the 4K frame in
sRGB and LAB and the 1024x768 frame), and B1's and B2's fast variants
(bf16 scores, the "average" tie mode, a bf16 filter) at 4K in sRGB and
LAB, B2 at 29, 45, 69 and 93 taps through both of its paths (the fused
kernel with any filter, and the two-pass one) and at 123 taps (above the
fused kernel's limit) through the two-pass path on the 1024x768 frame,
B2's split mode (the TPU kernel's f32x3) at 4K/pop4, each split check with
the fp32 mode's sums at least TEETH limits away, prints B2's peak device memory per
launch (4K/pop4, each batch bucket),
checks the annealing slice and the exact Lloyd polish against the plain
path on small inputs, then drives seven paths at full width, each with the
launch counts set to 0 just before it and read just after:

  parity            layer 2 of docs/PARITY.md at config-1 (512x512, K=16,
                    smooth): `tools.fitness_parity`, 2 batches of 4 random
                    palettes through B1 and B2 against the f64 oracle
                    (`tests/oracle.py`); it must print PASS at 1e-3;
  tpu_f32x3         fault C2's emulation of the TPU's whole f32x3 fitness
                    (`tools.tpu_f32x3` with conv "split": split_assign, then
                    B2 in its split mode) at config-1 natural, one batch of
                    4 palettes: every B2 launch in split mode, the fitness
                    against its plain version, split_assign and B2's split
                    mode each against their own, flips against B1;
  e2e               random init, imax=30: `HybridQuantizer(...).run` and
                    `error_image` (B1, B2; B3 in quantize);
  quality schedule  k-means seeds, imax=50, `.polish` (histogram at 4K),
                    `quantize`, `error_image` (B1, B2; B3: 35 Lloyd steps,
                    25 seeding all 4 members at once and 10 polishing, and
                    2 quantize lookups), then the exact polish at 4K (10
                    B3 Lloyd steps);
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
                    per bucket and B3 35 times (a Lloyd step of the
                    seeding or the polish, all 16 images at once) plus once
                    (quantize); after each bucket's count, its batched
                    fitness is held bit-equal to its images' own, and its
                    image-axis B1 (bf16, average) and B2 (bf16) launches and
                    B3's two modes at its shapes are held against their
                    plain versions; then the command itself on four of the
                    files, one per resolution, whose outputs must equal the
                    engine's for the same images and seeds.

The command writes only those four images and their error images: PNG
encoding of all 64 (and 64 error images) would spend tens of seconds of
host time in PIL that measure nothing of the port.

Then the probes' kernels (T1-T8: `csrc/probe_kloop.cu`, and
`csrc/split_assign.cu` in its assignment and max modes)
at 4K/K256/pop4 on the probe scripts' own inputs, every variant against its
plain version (phase_probes), and three more paths, each with the counts
set to 0 just before and read just after: the probe scripts' entry points
`tools.vpu_assign_exp`, `tools.kexp_assign` (also once at "highest", which
runs B1) and `tools.minidot_probe` with every variant (phase_probe_paths).
The engine paths above must launch none of the probe kernels.

Then the multi-device engine (parallel/, phase_mesh_b2s and phase_mesh):

  (a) B2s, B2 with column guards, at 3840x2160, K=256, pop 4 on B1's
      winners, split over 2 and over 4 shards by the engine's column plan:
      each shard against its plain version, the shards' total against
      whole-image B2, each shard timed beside mirror B2 on its width;
  (b) ShardedBatchQuantizer, strategy "columns", mesh (1, 1, 2): 2 gloo
      ranks sharing card 0 (spawned after the build), the quality schedule
      on the 4K frame (k-means, imax=50, polish 10, quantize, error_images),
      each rank's counts set to 0 just before and read just after; the
      ranks must agree bit for bit, their fitness of fixed palettes must
      equal the one-device engine's, and the anneal is printed beside
      `BatchQuantizer`'s at the same seed (final mean dE within 1%);
  (c) at 1920x1080 (crops of the 4K frame), imax 10, in one group of 4
      gloo ranks: rows (1, 1, 2), columns (1, 1, 2) and the pop axis
      (1, 2, 2), which must equal (1, 1, 2) bit for bit, and data (2, 1, 1)
      on two images, which must equal `BatchQuantizer` bit for bit;
  (d) with two cards or more, (b) again over NCCL, one rank per card, and
      the seconds per iteration per shard count of
      `tools.bench_multichip.measure_scaling`; on one card it says why not.

Ranks that share a card measure correctness and overhead, not scaling:
their collectives go through the host under gloo.

Each phase prints a line or a few. Before the last line it prints the card's
name and power limit and a JSON object with one entry per kernel (B1, B2,
B3's index mode and its Lloyd-step mode at top level: their numbers at the
batch's largest bucket and their launches there; the probe kernels: their
first variant and the probe paths' launches; B2's split mode as
`fused_fitness_f32x3`: its numbers at config-1, launches from the
tpu_f32x3 path); the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
so does a machine without a CUDA device.

Imports torch, numpy, the standard library and the port; never jax.
"""

from __future__ import annotations

import contextlib
import hashlib
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
SEED_STEPS = 25   # kmeans_init_palettes: 25 weighted Lloyd steps, each one B3 launch for every member (and image)
NEAR_TIE = 1e-5   # B1: |score gap| (f64) within which f32 rounding may pick either entry
# B3: near ties are relative, since LAB scores reach ~1e4 where one f32 ulp
# is ~1e-3: |gap| <= NEAR_TIE_REL * max(1, |score|) of the two entries
NEAR_TIE_REL = 1e-6
B2_RTOL = 1e-5    # B2: relative difference of each member's Delta-E sum
SMALL_ATOL = 2e-5  # slice on a small input, card vs plain path: fitness values
POLISH_ATOL = 1e-5  # Lloyd steps, card vs plain sums on the same winners (f64 sums in another order)
CLI_DE_RTOL = 1e-5  # cli `error` vs error_image on the same two files
# the batch phase: 16 images of each size, image i of size BATCH_SIZES[i % 4] from seed i
BATCH_SIZES = ((1080, 1920), (720, 1280), (768, 1024), (480, 640))
BATCH_IMAGES = 64
HIST_POLISH_PIXELS = 1 << 20  # polish_palette's "auto": the histogram from this many pixels an image on
LLOYD_RUN = SEED_STEPS + POLISH  # B3 Lloyd-step launches of a seeded, polished run (an image or a bucket)
# the probe kernels (T1-T8) and B2's split mode (the TPU's f32x3, reached only
# from fault C2's emulation): the engine paths launch none of them
OFF_ENGINE = {"probe_kloop": 0, "split_rowmax": 0, "split_assign": 0, "fused_fitness_split": 0}
# phase_parity: the port's layer-2 parity tool at config-1, 2 palette batches
PARITY_ARGS = ["--content", "smooth", "--size", "512", "--colors", "16", "--palettes", "2",
               "--population", "4", "--tolerance", "1e-3"]
# split-bf16 scores, kernel against plain: the tensor cores' f32 accumulation
# against a sequential sum of the same 12 exact products, relative to
# max(1, |score|) (4.8e-7 measured at 4K)
SPLIT_RTOL = 1e-6
# B2's split mode, and the emulated f32x3 fitness (split_assign, then B2 in
# split mode), kernel against plain on the same card operands, relative:
# 2.5e-7 measured at 4K/pop4, 1.5e-7 (B2) and 1.0e-7 (the fitness) at
# config-1 (NVIDIA H100 80GB HBM3, 700 W). Each such check also holds the
# fp32 mode's sums at least TEETH limits from the plain split's (2.7e-6 at
# 4K, 3.9e-6 and 2.7e-6 at config-1), or fails as unable to tell them apart
B2_SPLIT_RTOL = 8e-7
TEETH = 3
# bf16 row maxima that may round the other way from plain (1e-5 measured at 4K;
# a truncating kernel puts about half of them one ulp off)
BF16_OFF_SHARE = 1e-4

# the multi-device phases: B2s's shard counts, the smaller checks' frame and anneal
MESH_SHARDS = (2, 4)
MESH_H, MESH_W, MESH_IMAX = 1080, 1920, 10
MESH_DE_REL = 0.01  # final mean dE of the 2-rank anneal against the one-device one
FIT_RTOL = 1e-5   # fitness of fixed palettes, mesh against one device

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


def b2_bound(H: int, W: int, taps: int, pop: int, bf16: bool = False, images: int = 1,
             split: bool = False) -> dict:
    """B2: 7 filters x taps multiply-adds per pass, two passes, per member
    pixel, three of them in split mode (hi.hi + hi.lo + lo.hi; the LAB and
    Delta-E tail is left out, under a tenth of it); opponent images and
    targets in, sums out."""
    members = images * pop
    return bound((3 if split else 1) * 2.0 * 2 * 7 * taps * members * H * W,
                 4.0 * (3 * members * H * W + 3 * images * H * W + 14 * taps + members), bf16)


def b3_bound(F: int, M: int, P: int, K: int) -> dict:
    """B3 index mode: 3 multiply-adds per (row, entry, problem); each
    feature set read once for its M palettes, palettes in, indices out."""
    return bound(6.0 * F * M * P * K, 4.0 * (3 * F * P + 3 * F * M * K + F * M * P))


def lloyd_bound(F: int, M: int, P: int, K: int, weighted: bool) -> dict:
    """B3 Lloyd-step mode: the index mode's scan (its float64 sums, 8
    operations a row, are under 1% of it at K=256 and left out); features
    (and weights) read once, palettes in and out."""
    return bound(6.0 * F * M * P * K, 4.0 * (3 * F * P + weighted * F * P + 6 * F * M * K))


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
    host = {"taps_on_host": ctx["taps_on_host"]}
    got = ff.fused_scielab_err_sums(*args, **host)
    again = ff.fused_scielab_err_sums(*args, **host)
    want = ff.fused_scielab_err_sums_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("B2 sums differ between two identical launches")
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (torch.isfinite(got).all() and rel <= B2_RTOL):
        fail(f"B2 sums {got.tolist()} vs plain {want.tolist()}: rel {rel}")
    ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20)
    # the 2-D tile: 32-row segments, each recomputing its taps - 1 halo rows
    with _patched(ff, "ROWS_PER_BLOCK", ff.TILE_H):
        tiled = ff.fused_scielab_err_sums(*args, **host).double()
        tile_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20)
    if ((tiled - want.double()).abs() / want.double().abs()).max().item() > B2_RTOL:
        fail(f"B2 in 32-row tiles: {tiled.tolist()} vs plain {want.tolist()}")
    plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args), 3, warmup=1)
    max_abs = float((got - want).abs().max())
    peak = _peak_mib(lambda: ff.fused_scielab_err_sums(*args, **host))
    print(f"B2 fused_fitness {w}x{h} pop={pop} CIE76 taps={ctx['kh'].shape[1]}: mean dE "
          f"{(got / (h * w)).tolist()}; max rel diff {rel:.3g} <= {B2_RTOL}; "
          f"kernel {ms:.3f} ms ({ff.ROWS_PER_BLOCK}-row strips; 32-row tiles {tile_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms; peak device memory of one launch {peak:.3f} MiB above its inputs")
    return {"shape": f"{w}x{h}", "pop": pop, "max_abs_err": max_abs, "max_rel_err": rel,
            "ms": ms, "tile_ms": tile_ms, "plain_ms": plain_ms, "peak_mib_per_launch": peak,
            **b2_bound(h, w, ctx["kh"].shape[1], pop)}


def _hold_split(what: str, got, want, fp32) -> tuple[float, float]:
    """B2's split mode `got` against its plain version `want` within
    B2_SPLIT_RTOL, and the fp32 mode's sums `fp32` on the same inputs at
    least TEETH limits from `want`, so that a split without effect, or with
    the wrong arithmetic, would fail here: (rel, fp32's rel)."""
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    far = ((fp32.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (bool(torch.isfinite(got).all()) and rel <= B2_SPLIT_RTOL):
        fail(f"{what}: split {got.tolist()} vs plain {want.tolist()}: rel {rel} > {B2_SPLIT_RTOL}")
    if far < TEETH * B2_SPLIT_RTOL:
        fail(f"{what}: the fp32 mode sits {far:.3g} from plain split, under {TEETH} x {B2_SPLIT_RTOL}: "
             f"this input cannot tell the modes apart")
    return rel, far


def phase_b2_split(img, opp, dev) -> dict:
    """B2's split mode (precision "split", the TPU kernel's f32x3) at 4K/pop4
    on B1's winners `opp`: twice bit-equal, against its plain version by
    `_hold_split`, timed beside the fp32 mode. Its other paths (29 and 123
    taps, the slabs, the image axis) are held in tests/test_torch_cuda.py."""
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters

    (h, w, _), pop = img.shape, opp.shape[0]
    ctx = _make_context(img, build_filters(), QuantizationConfig(), dev)
    taps = ctx["kh"].shape[1]
    args = (opp.reshape(pop, 3, h, w), ctx["target_planar"], ctx["kh"], ctx["kv"], cs.WHITEPOINT_D65, "CIE76")
    host = {"taps_on_host": ctx["taps_on_host"]}
    before = ff.fused_scielab_err_sums.split_launches
    got = ff.fused_scielab_err_sums(*args, precision="split", **host)
    again = ff.fused_scielab_err_sums(*args, precision="split", **host)
    torch.cuda.synchronize()
    if ff.fused_scielab_err_sums.split_launches - before != 2:
        fail(f"B2 split: {ff.fused_scielab_err_sums.split_launches - before} split-mode launches of 2")
    if not torch.equal(got, again):
        fail(f"B2 split sums differ between two identical launches: {got.tolist()}, {again.tolist()}")
    want, plain_s = _timed(lambda: ff.fused_scielab_err_sums_reference(*args, precision="split"))
    rel, far = _hold_split(f"B2 split {w}x{h}", got, want, ff.fused_scielab_err_sums(*args, **host))
    ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, precision="split", **host), 20)
    fp32_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20)
    row = {"variant": "split (f32x3)", "shape": f"{w}x{h}", "pop": pop, "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": rel, "fp32_vs_plain_split_rel": far, "ms": ms, "fp32_ms": fp32_ms,
           "plain_ms": plain_s * 1e3, **b2_bound(h, w, taps, pop, split=True)}
    print(f"B2 split (f32x3) {w}x{h} pop={pop} CIE76: max rel diff from plain {rel:.3g} <= {B2_SPLIT_RTOL}, "
          f"bit-equal twice; the fp32 mode {far:.3g} from plain split (>= {TEETH} x {B2_SPLIT_RTOL}); "
          f"kernel {ms:.3f} ms (fp32 mode {fp32_ms:.3f} ms), plain {plain_s * 1e3:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return row


def _peak_mib(launch) -> float:
    """MiB that one call of `launch` allocates at its peak above what was
    allocated before it (torch.cuda.max_memory_allocated around it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    launch()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


# B2 filters other than the default, (dpi, viewing distance in cm): 29, 45,
# 69 and 93 taps at 45 cm, 123 taps at 300 dpi and 60 cm
B2_FILTERS = ((96, 45.0), (150, 45.0), (222, 45.0), (300, 45.0), (300, 60.0))


@contextlib.contextmanager
def _patched(module, name: str, value):
    """Set module.name to value for the block: to time a choice of B2's plan
    (fused_fitness.MAX_FUSED_TAPS, ROWS_PER_BLOCK) that it does not make."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def phase_b2_paths(dev) -> list[dict]:
    """B2 at the filters of B2_FILTERS on a 1024x768 frame at K=64, pop 4
    (B1's winners as q): each path that can take the filter (the fused
    kernel up to its shared-memory bound, 97 taps; the two-pass path at any
    taps) against its plain version (B2_RTOL), twice bit-equal, with its
    two-pass launch count, and timed; the plan's own path is marked
    "chosen". The times where both can run are the measurement behind
    fused_fitness.MAX_FUSED_TAPS."""
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.synth import natural_image

    img = natural_image(CLI_H, CLI_W, seed=3)
    pals = torch.rand((POP, CLI_K, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    opp = ak.assign_opp_usage_pop(torch.as_tensor(img, device=dev).reshape(-1, 3).contiguous(), pals,
                                  cs.srgb_to_opp(pals).contiguous())[0]
    rows = []
    for dpi, dist in B2_FILTERS:
        ctx = _make_context(img, build_filters(dpi, dist), QuantizationConfig(), dev)
        taps = ctx["kh"].shape[1]
        chosen = ff.fused_plan(CLI_H, CLI_W, taps)["path"]
        args = (opp.reshape(POP, 3, CLI_H, CLI_W), ctx["target_planar"], ctx["kh"], ctx["kv"],
                cs.WHITEPOINT_D65, "CIE76")
        want = ff.fused_scielab_err_sums_reference(*args)
        plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args), 3, warmup=1)
        paths = ("fused", "two_pass") if ff.fused_smem_bytes(taps) <= ff.SMEM_LIMIT else ("two_pass",)
        times = {}
        for path in paths:
            limit = taps if path == "fused" else taps - 1
            with _patched(ff, "MAX_FUSED_TAPS", limit) if path != chosen else contextlib.nullcontext():
                before = ff.fused_scielab_err_sums.two_pass_launches
                got = ff.fused_scielab_err_sums(*args)
                again = ff.fused_scielab_err_sums(*args)
                two_pass = ff.fused_scielab_err_sums.two_pass_launches - before
                torch.cuda.synchronize()
                rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
                if not (torch.equal(got, again) and bool(torch.isfinite(got).all()) and rel <= B2_RTOL):
                    fail(f"B2 {taps} taps ({path}): {got.tolist()} (again {again.tolist()}) vs plain "
                         f"{want.tolist()}")
                if two_pass != (2 if path == "two_pass" else 0):
                    fail(f"B2 {taps} taps: {two_pass} two-pass launches for the {path} path")
                ms = times[path] = cuda_ms(lambda: ff.fused_scielab_err_sums(*args), 20)
                peak = _peak_mib(lambda: ff.fused_scielab_err_sums(*args))
            rows.append({"variant": f"{path}, {taps} taps", "chosen": path == chosen, "shape": f"{CLI_W}x{CLI_H}",
                         "pop": POP, "taps": taps, "max_abs_err": float((got - want).abs().max()),
                         "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms, "peak_mib_per_launch": peak,
                         "two_pass_launches": two_pass, **b2_bound(CLI_H, CLI_W, taps, POP)})
        print(f"B2 {CLI_W}x{CLI_H} pop={POP} taps={taps} ({dpi} dpi, {dist:g} cm), the plan takes {chosen}: "
              + "; ".join(f"{p} kernel {t:.3f} ms" for p, t in times.items())
              + f"; plain {plain_ms:.3f} ms; each within {B2_RTOL} of plain, bit-equal twice")
    return rows


def _b3_check(feats, pals) -> tuple[torch.Tensor, int, float, float]:
    """B3's index mode against its plain version on the card, on (P, 3) x
    (K, 3) or (F, P, 3) x (F, M, K, 3): (indices, mismatches, largest
    absolute score gap among them, largest gap relative to max(1, |score|)).
    Fails when a mismatch lies outside the relative near-tie class."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    idx = ak.assign_idx(feats, pals)
    want = ak.assign_idx_reference(feats, pals)
    torch.cuda.synchronize()
    K = pals.shape[-2]
    if int(idx.min()) < 0 or int(idx.max()) >= K:
        fail(f"B3 index out of range: [{int(idx.min())}, {int(idx.max())}]")
    F3, P3 = (feats, pals) if feats.dim() == 3 else (feats[None], pals[None, None])
    diff = (idx != want).reshape(P3.shape[0], P3.shape[1], -1)
    n_diff = int(diff.sum())
    if not n_diff:
        return idx, 0, 0.0, 0.0
    f, m, i = torch.nonzero(diff, as_tuple=True)
    x = F3[f, i].double()
    got, ref = idx.reshape(diff.shape)[f, m, i].long(), want.reshape(diff.shape)[f, m, i].long()
    ca, cb = P3[f, m, got].double(), P3[f, m, ref].double()
    sa = (x * ca).sum(-1) - 0.5 * (ca * ca).sum(-1)
    sb = (x * cb).sum(-1) - 0.5 * (cb * cb).sum(-1)
    gap = (sa - sb).abs()
    rel = gap / torch.maximum(sa.abs(), sb.abs()).clamp_min(1.0)
    if float(rel.max()) > NEAR_TIE_REL:
        fail(f"B3 index differs from the plain version off the near-tie class (rel gap {float(rel.max())})")
    return idx, n_diff, float(gap.max()), float(rel.max())


def _lloyd_check(label, feats, pals, weights, idx) -> dict:
    """B3's Lloyd-step mode on (F, P, 3) x (F, M, K, 3) against the plain
    sums (centroid_update) on the index mode's winners (`idx`, which equal
    the plain version's off the near-tie class): within POLISH_ATOL, and
    within it of the whole plain version (lloyd_step_reference) where the
    winners are the same; each problem's launch on its own and a second
    launch bit-equal to the batched one."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    got = ak.lloyd_step(feats, pals, weights)
    plain = ak.lloyd_step_reference(feats, pals, weights)
    again = ak.lloyd_step(feats, pals, weights)
    torch.cuda.synchronize()
    F, M = pals.shape[:2]
    on_winners, singles_equal = 0.0, True
    for f in range(F):
        w = None if weights is None else weights[f]
        for m in range(M):
            want = ak.centroid_update(feats[f], idx[f, m], pals[f, m], w)
            on_winners = max(on_winners, float((got[f, m] - want).abs().max()))
            singles_equal &= torch.equal(ak.lloyd_step(feats[f], pals[f, m], w), got[f, m])
    max_abs = float((got - plain).abs().max())
    same_winners = torch.equal(idx, ak.assign_idx_reference(feats, pals))
    if not (on_winners <= POLISH_ATOL and (max_abs <= POLISH_ATOL or not same_winners)):
        fail(f"B3 Lloyd step {label}: max |diff| {on_winners} from the plain sums on its winners, "
             f"{max_abs} from the plain version (same winners: {same_winners})")
    if not torch.equal(got, again) or not singles_equal:
        fail(f"B3 Lloyd step {label}: not bit-equal run to run ({torch.equal(got, again)}) or to "
             f"its problems' own launches ({singles_equal})")
    return {"max_abs_err": max_abs, "max_abs_err_on_winners": on_winners, "same_winners": same_winners,
            "repeat_bit_equal": True, "batched_bit_equal": True}


def _b3_cases(img_dev, pals, cli_dev) -> list:
    """(label, features (F, P, 3), palettes (F, M, K, 3), weights) at every
    shape the main paths give B3: the k-means seeding (an image's 2^15 bins
    x its 4 members; a bucket's 16 images x 4 members), the 1080p bucket's
    histogram polish (16 x 2^18 bins), the 720p bucket's exact polish (16 x
    1280x720 pixels), and the 4K frame (quantize; the exact polish) in sRGB
    and LAB; the cli frame (its exact polish and quantize). Bucket images
    are crops of the 4K frame, palettes random in sRGB."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops.kmeans import color_histogram

    g = torch.Generator().manual_seed(5)
    rand = lambda *shape: torch.rand(shape, generator=g).to(img_dev.device)  # noqa: E731
    k = pals.shape[1]
    crops = lambda h, w: torch.stack([  # noqa: E731
        img_dev[y:y + h, x:x + w].reshape(-1, 3)
        for y in torch.linspace(0, H - h, 4).long().tolist() for x in torch.linspace(0, W - w, 4).long().tolist()])
    (h1, w1), (h2, w2) = BATCH_SIZES[:2]
    px = img_dev.reshape(1, -1, 3)
    counts, centers = color_histogram(px, 5)
    big = crops(h1, w1)
    b_counts, b_centers = color_histogram(big, 5)
    h_counts, h_centers = color_histogram(big, 6)
    lab = cs.srgb_to_lab(px).contiguous()
    return [
        (f"seeding {W}x{H} 2^15 bins x {POP} members", centers, pals[None].contiguous(), counts),
        (f"seeding bucket 16 x {w1}x{h1} 2^15 bins x {POP} members", b_centers, rand(16, POP, k, 3), b_counts),
        (f"histogram polish bucket 16 x {w1}x{h1} 2^18 bins", h_centers, rand(16, 1, k, 3), h_counts),
        (f"exact polish bucket 16 x {w2}x{h2}", crops(h2, w2), rand(16, 1, k, 3), None),
        (f"{W}x{H} srgb", px, pals[:1, None].contiguous(), None),
        (f"{W}x{H} lab", lab, cs.srgb_to_lab(pals[:1, None]).contiguous(), None),
        (f"{CLI_W}x{CLI_H} srgb", cli_dev.reshape(1, -1, 3), rand(1, 1, CLI_K, 3), None),
    ]


def phase_b3(cases) -> tuple[list, list]:
    """B3's two modes against their plain versions at every shape in
    `cases` (_b3_cases), each timed with its bound: (index rows, Lloyd rows)."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak

    idx_rows, lloyd_rows = [], []
    for label, feats, p, w in cases:
        (F, P, _), (_, M, k, _) = feats.shape, p.shape
        idx, n_diff, gap, rel = _b3_check(feats, p)
        ms = cuda_ms(lambda: ak.assign_idx(feats, p), 20)
        plain_ms = cuda_ms(lambda: ak.assign_idx_reference(feats, p), 3, warmup=1)
        shape = {"case": label, "F": F, "M": M, "P": P, "K": k}
        idx_rows.append({**shape, "max_abs_err": gap, "max_rel_gap": rel, "index_mismatches": n_diff,
                         "ms": ms, "plain_ms": plain_ms, **b3_bound(F, M, P, k)})
        check = _lloyd_check(label, feats, p, w, idx)
        l_ms = cuda_ms(lambda: ak.lloyd_step(feats, p, w), 20)
        l_plain = cuda_ms(lambda: ak.lloyd_step_reference(feats, p, w), 2, warmup=1)
        lloyd_rows.append({**shape, "weighted": w is not None, **check, "ms": l_ms, "plain_ms": l_plain,
                           **lloyd_bound(F, M, P, k, w is not None)})
        print(f"B3 {label} (F={F} M={M} P={P} K={k}): index {n_diff} differ (relative gap {rel:.3g} <= "
              f"{NEAR_TIE_REL}), kernel {ms:.3f} ms (bound {idx_rows[-1]['bound_ms']:.3f}), plain "
              f"{plain_ms:.3f} ms; Lloyd step max |diff| {check['max_abs_err_on_winners']:.3g} on its "
              f"winners (<= {POLISH_ATOL}), {check['max_abs_err']:.3g} from plain, bit-equal run to run and "
              f"to {F * M} single launches, kernel {l_ms:.3f} ms (bound {lloyd_rows[-1]['bound_ms']:.3f}), "
              f"plain {l_plain:.3f} ms")
    return idx_rows, lloyd_rows


def phase_small_polish(dev) -> None:
    """Ten exact Lloyd steps on a small input, card (B3's Lloyd-step mode)
    against the CPU (plain version), from the same palette."""
    from hybridquantization_tpu_torch.ops import assign as assign_ops
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.synth import natural_image

    px = torch.as_tensor(natural_image(96, 128, seed=7)).reshape(-1, 3)
    pal = torch.rand((8, 3), generator=torch.Generator().manual_seed(12))
    before = ak.lloyd_step.launches
    got = assign_ops.lloyd_polish(px.to(dev), pal.to(dev), POLISH).cpu()
    launches = ak.lloyd_step.launches - before
    want = assign_ops.lloyd_polish(px, pal, POLISH)
    err = float((got - want).abs().max())
    if launches != POLISH or not err <= POLISH_ATOL:
        fail(f"small polish: {launches} B3 Lloyd-step launches, max |palette diff| {err}")
    print(f"polish 128x96 K=8, {POLISH} exact Lloyd steps, card (B3 Lloyd step, {launches} launches) vs "
          f"plain path: max |palette diff| {err:.3g} <= {POLISH_ATOL}")


def _counts() -> dict:
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.ops import probe_kernels as pk

    return {"assign_pop": ak.assign_opp_usage_pop.launches,
            "fused_fitness": ff.fused_scielab_err_sums.launches,
            "fused_fitness_split": ff.fused_scielab_err_sums.split_launches,
            "assign_idx": ak.assign_idx.launches,
            "lloyd_step": ak.lloyd_step.launches,
            "probe_kloop": pk.kloop_assign.launches,
            "split_rowmax": pk.split_rowmax.launches,
            "split_assign": pk.split_assign.launches}


def _reset_counts() -> None:
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.ops import probe_kernels as pk

    for fn in (ak.assign_opp_usage_pop, ff.fused_scielab_err_sums, ak.assign_idx, ak.lloyd_step,
               pk.kloop_assign, pk.split_rowmax, pk.split_assign):
        fn.launches = 0
    ak.lloyd_step.unfused_launches = 0
    ff.fused_scielab_err_sums.slab_launches = 0
    ff.fused_scielab_err_sums.two_pass_launches = 0
    ff.fused_scielab_err_sums.split_launches = 0


def _fused_only(what: str) -> None:
    """Fail if B2 took its two-pass path, or a Lloyd step the index mode and
    plain sums, since the counts were reset: at the default 21 taps and
    K=256 every launch is the fused kernel."""
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff

    if ff.fused_scielab_err_sums.two_pass_launches:
        fail(f"{what}: B2 took the two-pass path {ff.fused_scielab_err_sums.two_pass_launches} times")
    if ak.lloyd_step.unfused_launches:
        fail(f"{what}: {ak.lloyd_step.unfused_launches} Lloyd steps ran unfused")


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
    # B3: the run's quantize and the final one; the seeding's and the polish's Lloyd steps
    want = {"assign_pop": 1 + QS_IMAX, "fused_fitness": 1 + QS_IMAX, "assign_idx": 2,
            "lloyd_step": LLOYD_RUN, **OFF_ENGINE}
    if launches != want:
        fail(f"the schedule launched {launches}, not {want}")
    _fused_only("the schedule")
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
    error_image; then the exact polish at 4K. B3 runs every Lloyd step of
    the seeding (all members in one launch) and of the polish, and both
    quantize passes (the run's own and the final one)."""
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
    b3 = exact_launches["lloyd_step"]
    if b3 != POLISH or exact_launches["assign_idx"]:
        fail(f"the exact polish launched {exact_launches}, not {POLISH} Lloyd steps")
    _fused_only("the exact polish")
    if not (bool(torch.isfinite(exact).all()) and float(exact.min()) >= 0 and float(exact.max()) <= 1):
        fail(f"exact polish palette out of range: [{float(exact.min())}, {float(exact.max())}]")
    mean_exact, _ = q.error_image(img, q.quantize(img, exact))
    print(f"quality schedule {W}x{H} K={K} pop={POP} kmeans + imax={QS_IMAX} + {POLISH} hist "
          f"polish: {secs['e2e']:.3f} s end to end (run {secs['run']:.3f} s of which anneal "
          f"{info['seconds']:.3f} s; polish {secs['polish']:.3f} s, quantize {secs['quantize']:.3f} s, "
          f"error_image {secs['error_image']:.3f} s; warm repeats: context {t_ctx:.3f} s, k-means seeding "
          f"{t_seed:.3f} s); best fitness {info['best_error']:.5f}, mean S-CIELAB dE "
          f"{mean:.5f} (random init imax={IMAX}: {random_de:.5f}), {n_colors} colours; "
          f"launches {launches}; exact polish {t_exact:.3f} s, {b3} B3 Lloyd steps, dE after "
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
        # B3: the k-means seeding's and the exact polish's Lloyd steps, the dithered quantize
        want = {"assign_pop": 1 + CLI_IMAX, "fused_fitness": 1 + CLI_IMAX, "assign_idx": 1,
                "lloyd_step": LLOYD_RUN, **OFF_ENGINE}
        if first != want:
            fail(f"cli quantize launched {first}, not {want}")
        _fused_only("cli quantize")
        quant_de = float(re.findall(r"DeltaE : (\S+)", text)[-1])

        text2, second, _ = run(argv)
        if "resuming from" not in text2 or f"at iteration {CLI_IMAX}" not in text2:
            fail(f"cli second run did not resume at iteration {CLI_IMAX}: {text2[-500:]}")
        # no seeding and no iteration: B3 only in the polish and the quantize
        want = {"assign_pop": 0, "fused_fitness": 0, "assign_idx": 1, "lloyd_step": POLISH, **OFF_ENGINE}
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
          f"{quant_de:.5f} (float output); launches {first} (B3: {SEED_STEPS} seeding steps for all members + "
          f"{POLISH} exact polish steps, 1 quantize); resumed run launches {second}; cli error dE {cli_de:.6f} = "
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
    host = {"taps_on_host": ctx["taps_on_host"]}
    got = ff.fused_scielab_err_sums(*args, precision="bf16", **host)
    again = ff.fused_scielab_err_sums(*args, precision="bf16", **host)
    want = ff.fused_scielab_err_sums_reference(*args, precision="bf16")
    exact = ff.fused_scielab_err_sums(*args, **host)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("B2 bf16 sums differ between two identical launches")
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (torch.isfinite(got).all() and rel <= B2_RTOL):
        fail(f"B2 bf16 sums {got.tolist()} vs plain {want.tolist()}: rel {rel}")
    vs_exact = ((got.double() - exact.double()).abs() / exact.double().abs()).max().item()
    ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, precision="bf16", **host), 20)
    exact_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20)
    plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args, precision="bf16"), 3, warmup=1)
    taps = ctx["kh"].shape[1]
    print(f"B2 fast bf16 {w}x{h} pop={pop}: max rel diff from the plain version {rel:.3g} <= {B2_RTOL}; "
          f"from fp32 {vs_exact:.3g}; kernel {ms:.3f} ms (exact {exact_ms:.3f} ms), plain {plain_ms:.3f} ms")
    b2 = [{"variant": "bf16", "shape": f"{w}x{h}", "pop": pop, "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": rel, "rel_from_fp32": vs_exact, "ms": ms, "exact_ms": exact_ms,
           "plain_ms": plain_ms, **b2_bound(h, w, taps, pop, bf16=True)}]
    return b1, b2


def _bucket_kernels(ctx, pals, palettes, cfg) -> dict:
    """One bucket's image-axis launches of B1 and B2 in the variants
    `quantize-batch --fast` runs them (bf16 + average; bf16) against their
    plain versions on the same (B, P, 3) features and (B, pop, K, 3)
    palettes (B1: zero index, count and colour mismatches, as in
    phase_fast_kernels; B2 within B2_RTOL), and B3's two modes at the
    bucket's shapes with each image's final palette (`palettes`, (B, K, 3)):
    quantize's lookup (the relative near-tie class) and a polish step
    (_lloyd_check); each timed beside its plain version."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.ops.kmeans import color_histogram
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
    host = {"taps_on_host": ctx["taps_on_host"]}
    got = ff.fused_scielab_err_sums(*args, precision=conv, **host)
    want, t_b2 = _timed(lambda: ff.fused_scielab_err_sums_reference(*args, precision=conv))
    rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
    if not (bool(torch.isfinite(got).all()) and rel <= B2_RTOL):
        fail(f"B2 {conv} bucket {bucket} x{n}: rel {rel} from the plain version on the image axis")
    b2_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, precision=conv, **host), 5)
    b2_abs = float((got - want).abs().max())
    b2_peak = _peak_mib(lambda: ff.fused_scielab_err_sums(*args, precision=conv, **host))
    del opp, args

    # B3 at the bucket's shapes: quantize's lookup (each image's final
    # palette), and a Lloyd step of its polish (the histogram from 2^20
    # pixels an image on, as polish_palette's "auto")
    pals3 = palettes[:, None].contiguous()
    idx, n3, gap, rel3 = _b3_check(feats, pals3)
    b3_ms = cuda_ms(lambda: ak.assign_idx(feats, pals3), 20)
    b3_plain = cuda_ms(lambda: ak.assign_idx_reference(feats, pals3), 3, warmup=1)
    if P >= HIST_POLISH_PIXELS:
        counts, centers = color_histogram(feats, 6)
        polish = ("histogram polish", centers.contiguous(), counts)
        idx = ak.assign_idx(centers, pals3)
    else:
        polish = ("exact polish", feats, None)
    what, lf, lw = polish
    check = _lloyd_check(f"bucket {bucket} x{n} {what}", lf, pals3, lw, idx)
    l_ms = cuda_ms(lambda: ak.lloyd_step(lf, pals3, lw), 20)
    l_plain = cuda_ms(lambda: ak.lloyd_step_reference(lf, pals3, lw), 2, warmup=1)
    print(f"batch bucket {bucket} x{n} against the plain versions: B1 {kw['precision']} "
          f"{kw['tie_mode']} image axis 0 index/colour and 0 count mismatches, kernel {b1_ms:.3f} ms, "
          f"plain {t_b1 * 1e3:.3f} ms; B2 {conv} image axis max rel diff {rel:.3g} <= {B2_RTOL}, kernel "
          f"{b2_ms:.3f} ms, plain {t_b2 * 1e3:.3f} ms, peak of one launch {b2_peak:.3f} MiB; B3 quantize "
          f"lookup F={n} K={k}: {n3} indices differ (relative gap {rel3:.3g} <= {NEAR_TIE_REL}), kernel "
          f"{b3_ms:.3f} ms, plain {b3_plain:.3f} ms; B3 {what} step P={lf.shape[1]}: max |diff| "
          f"{check['max_abs_err_on_winners']:.3g} on its winners, {check['max_abs_err']:.3g} from plain, "
          f"bit-equal run to run and to single launches, kernel {l_ms:.3f} ms, plain {l_plain:.3f} ms")
    row = {"bucket": bucket, "images": n, "bucket_pixels": n * P}
    return {
        "assign_pop": {**row, "variant": f"srgb {kw['precision']} {kw['tie_mode']}", "K": k, "pop": pop,
                       "max_abs_err": b1_abs, "index_mismatches": n_diff, "count_mismatches": count_diff,
                       "ms": b1_ms, "plain_ms": t_b1 * 1e3, **b1_bound(P, k, pop, bf16=True, images=n)},
        "fused_fitness": {**row, "variant": conv, "pop": pop, "max_abs_err": b2_abs, "max_rel_err": rel,
                          "ms": b2_ms, "plain_ms": t_b2 * 1e3, "peak_mib_per_launch": b2_peak,
                          **b2_bound(h, w, ctx["kh"].shape[1], pop, bf16=True, images=n)},
        "assign_idx": {**row, "case": "quantize lookup", "F": n, "M": 1, "P": P, "K": k, "max_abs_err": gap,
                       "max_rel_gap": rel3, "index_mismatches": n3, "ms": b3_ms, "plain_ms": b3_plain,
                       **b3_bound(n, 1, P, k)},
        "lloyd_step": {**row, "case": what, "F": n, "M": 1, "P": lf.shape[1], "K": k, **check,
                       "ms": l_ms, "plain_ms": l_plain, **lloyd_bound(n, 1, lf.shape[1], k, lw is not None)},
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
            _fused_only(f"batch bucket {stack.shape[2]}x{stack.shape[1]}")
            peak = torch.cuda.max_memory_allocated()
            n, h, w, _ = stack.shape
            want = {"assign_pop": 1 + QS_IMAX, "fused_fitness": 1 + QS_IMAX, "assign_idx": 1,
                    "lloyd_step": LLOYD_RUN, **OFF_ENGINE}
            if launches != want:
                fail(f"batch bucket {w}x{h} of {n} launched {launches}, not {want}")
            colours = max(len(torch.unique(o.reshape(-1, 3), dim=0)) for o in out)
            if not (bool(torch.isfinite(de).all()) and bool(torch.isfinite(out).all())) or colours > K:
                fail(f"batch bucket {w}x{h}: dE {de.tolist()}, {colours} colours")
            print(f"batch bucket {w}x{h} x{n}: {secs:.3f} s, {n * h * w / secs / 1e6:.2f} Mpix/s, "
                  f"mean dE {float(de.mean()):.5f}, launches {launches} (B1/B2 1 + imax, B3 {LLOYD_RUN} Lloyd "
                  f"steps and 1 quantize per bucket), "
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
            rows = _bucket_kernels(bctx, pals, info["palettes"], cfg)
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
        want = {"assign_pop": 4 * (1 + QS_IMAX), "fused_fitness": 4 * (1 + QS_IMAX), "assign_idx": 4,
                "lloyd_step": 4 * LLOYD_RUN, **OFF_ENGINE}
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


def phase_parity() -> dict:
    """Layer 2 of the parity protocol (docs/PARITY.md) at config-1 (512x512,
    K=16, smooth): the port's `tools.fitness_parity` on the card, 2 palette
    batches of population 4, against the f64 oracle at tolerance 1e-3, the
    counts set to 0 just before and read just after. It must print PASS and
    launch B1 and B2, and no probe kernel."""
    from hybridquantization_tpu_torch.tools import fitness_parity

    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fitness_parity.main(PARITY_ARGS)
    secs = time.perf_counter() - t0
    launches = _counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln]
    print("\n".join(f"parity: {ln}" for ln in lines))
    if rc != 0 or "DETERMINISTIC PARITY: PASS" not in lines[-1]:
        fail(f"fitness_parity {' '.join(PARITY_ARGS)}: rc {rc}, {lines[-1]}")
    if launches["assign_pop"] == 0 or launches["fused_fitness"] == 0:
        fail(f"fitness_parity launched {launches}: B1 and B2 at least once")
    if {k: launches[k] for k in OFF_ENGINE} != OFF_ENGINE:
        fail(f"fitness_parity launched a kernel no engine path launches: {launches}")
    print(f"parity: fitness_parity {' '.join(PARITY_ARGS)} in {secs:.1f} s, launches {launches}")
    return launches


def phase_tpu_f32x3(dev) -> tuple[dict, dict, dict]:
    """Fault C2's emulation of the whole TPU f32x3 fitness (`tools.tpu_f32x3`
    with conv "split": split_assign at f32x3, then B2 in its split mode) at
    config-1 (512x512 natural, K=16, pop 4) on one batch of 4 random
    palettes, the counts set to 0 just before and read just after: every B2
    launch in split mode; split_assign against its plain version on the
    card's operands by `_check_split_first`; the fitness against the plain
    versions of both kernels on the same operands, and B2's split mode on
    split_assign's colours against its own, each by `_hold_split` (the
    emulation with fp32 B2, and B2's fp32 mode, as the teeth), timed;
    split_assign's flips against B1 (fp32) printed. Returns (launches, the
    split_assign row and the B2 split row at this shape)."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.ops import probe_kernels as pk
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.swasa import schedule
    from hybridquantization_tpu_torch.tools import pack_pixels, tpu_f32x3
    from hybridquantization_tpu_torch.tools.parity_check import content_image

    size, k, pop = 512, 16, 4
    img = content_image("natural", size)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=k, population=pop))
    pals = torch.rand((pop, k, 3), generator=torch.Generator().manual_seed(4))
    ctx = _make_context(img, build_filters(), cfg, dev)
    fit = tpu_f32x3.make_split_population_fitness(ctx, cfg, "split")
    pals_dev = pals.to(dev)
    _reset_counts()
    err, _ = fit(pals_dev)
    torch.cuda.synchronize()
    launches = _counts()
    if (launches["split_assign"] == 0 or launches["fused_fitness"] == 0 or launches["assign_pop"]
            or launches["fused_fitness_split"] != launches["fused_fitness"]):
        fail(f"tpu_f32x3 fitness launched {launches}: split_assign and B2 in split mode, and not B1")
    x4 = pack_pixels(ctx["assign_pixels"])
    c4, o4 = pk.pack_palette(pals_dev, cs.srgb_to_opp(pals_dev))
    (opp, counts, idx), (p_opp, p_counts, p_idx), plain_ms = _versus(
        lambda *a: pk.split_assign(*a, return_index=True),
        lambda *a: pk.split_assign_reference(*a, return_index=True), x4, c4, o4)
    n, count = _check_split_first("tpu_f32x3 split_assign", x4, c4, (opp, counts, idx), (p_opp, p_counts, p_idx))
    # the whole fitness against split_assign's and B2's plain versions, as
    # make_split_population_fitness composes them
    b2_plain = (ctx["target_planar"], ctx["kh"], ctx["kv"], ctx["whitepoint"], cfg.deltaE)
    want = (ff.fused_scielab_err_sums_reference(p_opp.reshape(pop, 3, size, size), *b2_plain, precision="split")
            / (size * size) + schedule.unused_penalty(p_counts > 0, cfg.swasa.delta))
    fp32_conv, _ = tpu_f32x3.make_split_population_fitness(ctx, cfg, "fp32")(pals_dev)
    rel, fit_far = _hold_split("tpu_f32x3 fitness", err, want, fp32_conv)
    ms = cuda_ms(lambda: pk.split_assign(x4, c4, o4), 20)
    P = size * size
    b = split_bound(P, k, pop, 4.0 * (4 * P + 8 * pop * k + 3 * pop * P + pop * k), 2)
    _, _, b1_idx = ak.assign_opp_usage_pop(ctx["assign_pixels"], pals_dev, cs.srgb_to_opp(pals_dev),
                                           return_index=True)
    flips = (idx != b1_idx).float().mean(1).tolist()
    fit_ms = cuda_ms(lambda: fit(pals_dev), 20)
    # B2's split mode on the colours split_assign gave this batch
    q = opp.reshape(pop, 3, size, size)
    b2_args = (q, ctx["target_planar"], ctx["kh"], ctx["kv"], ctx["whitepoint"], cfg.deltaE)
    b2_kw = {"precision": "split", "taps_on_host": ctx["taps_on_host"]}
    b2_got = ff.fused_scielab_err_sums(*b2_args, **b2_kw)
    b2_want, b2_plain_s = _timed(lambda: ff.fused_scielab_err_sums_reference(*b2_args, precision="split"))
    b2_rel, b2_far = _hold_split("B2 split at config-1", b2_got, b2_want, ff.fused_scielab_err_sums(
        *b2_args, taps_on_host=ctx["taps_on_host"]))
    b2_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*b2_args, **b2_kw), 20)
    b2_fp32_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*b2_args, taps_on_host=ctx["taps_on_host"]), 20)
    b2_row = {"variant": "B2 f32x3 (tpu_f32x3 conv split, config-1 natural)", "shape": f"{size}x{size}",
              "pop": pop, "max_abs_err": float((b2_got - b2_want).abs().max()), "max_rel_err": b2_rel,
              "fp32_vs_plain_split_rel": b2_far, "ms": b2_ms, "fp32_ms": b2_fp32_ms, "plain_ms": b2_plain_s * 1e3,
              **b2_bound(size, size, ctx["kh"].shape[1], pop, split=True),
              "launches_from": "tpu_f32x3_config1", "launches": launches["fused_fitness_split"]}
    print(f"tpu_f32x3 config-1 natural 512x512 K={k} pop={pop}: the whole emulated fitness (conv split) on "
          f"the card vs plain max rel gap {rel:.3g} <= {B2_SPLIT_RTOL}, with fp32 B2 {fit_far:.3g} "
          f"({fit_ms:.3f} ms an evaluation); "
          f"split_assign {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
          f"{n} winners off plain (near ties); B2 split {b2_ms:.3f} ms (fp32 mode {b2_fp32_ms:.3f} ms), plain "
          f"{b2_plain_s * 1e3:.3f} ms, bound {b2_row['bound_ms']:.4f} ms ({b2_row['bound_by']}), rel {b2_rel:.3g} "
          f"(fp32 mode {b2_far:.3g}); "
          f"flips against B1 (fp32) per member " + " ".join(f"{f:.3e}" for f in flips)
          + f"; launches {launches}")
    row = {"variant": "T4 f32x3 (tpu_f32x3, config-1 natural)", "replaces": "tools/kexp_assign.py:271",
           "ms": ms, "plain_ms": plain_ms, **b, "K": k, "P": P,
           "max_abs_err": float((opp - p_opp).abs().max()), "winner_mismatches": n,
           "count_mismatches": count, "fitness_max_rel_gap": rel, "fitness_fp32_conv_rel": fit_far,
           "flips_against_b1": flips, "launches_from": "tpu_f32x3_config1",
           "launches": launches["split_assign"]}
    return launches, row, b2_row


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


def split_bound(P: int, kc: int, pop: int, nbytes: float, f32_per_score: int) -> dict:
    """The split kernels: 12 bf16 multiply-adds per (pixel, candidate,
    member) at the bf16 tensor-core peak, and the max (1) or compare and
    select (2) fp32 instructions per score, each one issue slot of a lane:
    PEAK_F32 / 2 instructions a second (PEAK_F32 counts an FMA as two
    operations; this takes FMNMX and the compare at the FMA pipe's rate).
    The larger of the two is the operations term (`ops_term` says which),
    against the bytes."""
    scores = float(P) * kc * pop
    tc_ms = 2.0 * 12 * scores / PEAK_BF16 * 1e3
    f32_ms = f32_per_score * scores / (PEAK_F32 / 2) * 1e3
    out = bound(0.0, nbytes)
    if max(tc_ms, f32_ms) > out["bound_ms"]:
        out.update(bound_ms=max(tc_ms, f32_ms), bound_by="operations")
    return {**out, "ops_term": "tensor cores (bf16)" if tc_ms >= f32_ms else "fp32 max/compare",
            "tensor_ms": tc_ms, "fp32_ms": f32_ms}


def _versus(kern, plain, x4, c, o=None):
    """A kernel and its plain version on the same operands, every pixel:
    (kernel out, plain out, plain ms)."""
    want, t = _timed(lambda: plain(x4, c, o))
    got = kern(x4, c, o)
    torch.cuda.synchronize()
    return got, want, t * 1e3


def _check_split_first(what: str, x4, c, got, want) -> tuple[int, int]:
    """First-index split_assign (dense, opp_parts=3) against its plain
    version: winners differ only in the near-tie class; where they agree the
    colour is bit-equal (the 3-part gather is exact); each differing winner
    moves one pixel between two counts, which sum to P. Returns (differing
    winners, count mismatches)."""
    (opp, counts, idx), (p_opp, p_counts, p_idx) = got, want
    same = idx == p_idx
    if not torch.equal(opp.transpose(1, 2)[same], p_opp.transpose(1, 2)[same]):
        fail(f"{what}: the colour differs from the plain version's where the winners agree")
    n, worst, _ = _split_near_ties(x4, c, None, ~same)
    if n and worst > NEAR_TIE_REL:
        fail(f"{what}: {n} winners off plain, gap up to {worst:.3g} > {NEAR_TIE_REL}")
    count = int((counts - p_counts).abs().sum())
    total = counts.sum(1)
    if count > 2 * n or not bool((total == x4.shape[1]).all()):
        fail(f"{what}: {count} count mismatches for {n} differing winners (limit {2 * n}), counts "
             f"sum to {total.tolist()} ({x4.shape[1]} px)")
    return n, count


def _split_near_ties(x4, c, run, mask) -> tuple[int, float, int]:
    """(pixels in `mask`, the largest gap between their two best plain split
    scores relative to max(1, |score|), the number of candidates summed over
    those pixels whose plain score lies within NEAR_TIE_REL * max(1, |top|)
    of the top): where kernel and plain disagree (winner, or in average mode
    the set of hits), that gap must lie in the near-tie class, and in average
    mode only candidates of the class may change their hits."""
    from hybridquantization_tpu_torch.ops import probe_kernels as pk

    m, i = torch.nonzero(mask, as_tuple=True)
    worst, in_class = 0.0, 0
    for lo in range(0, m.numel(), 1 << 14):
        mm, ii = m[lo:lo + (1 << 14)], i[lo:lo + (1 << 14)]
        cands = c[mm] if run is None else c[mm, ii // run]
        s = pk._split_scores(x4[:, ii][:, :, None], cands)[:, 0]
        s = torch.where(torch.isnan(s), float("-inf"), s)
        if s.shape[-1] < 2:
            return int(m.numel()), float("inf"), 0
        top, second = torch.topk(s, 2, dim=-1).values.unbind(-1)
        scale = top.abs().clamp_min(1.0)
        worst = max(worst, float(((top - second) / scale).max()))
        in_class += int((s >= (top - NEAR_TIE_REL * scale)[:, None]).sum())
    return int(m.numel()), worst, in_class


def phase_probes(dev) -> dict:
    """The probes' kernels (T1-T8) at 4K/K256/pop4 on the probe scripts' own
    inputs (each `main`'s numpy seed-0 draws, palette set 0), every variant
    against its plain version on every pixel, each distinct launch timed
    once beside it (kernel: CUDA events over 20 launches; plain: one
    synchronized call): the k-loop bit for bit (0 colour and count
    mismatches); the split row max within SPLIT_RTOL, or with bf16 outputs
    the rounding of a value within SPLIT_RTOL of the plain f32 maximum, the
    other way from plain on at most BF16_OFF_SHARE of them, and bit for bit
    the rounding of the kernel's own f32 maxima; the split
    assignment's index, colour and count mismatches only in the relative
    near-tie class, counts summing to P per member (hits at least P in
    average mode). A variant that is the same launch as another carries its
    time and names it under `same_launch_as`. Returns {kernel: [variant
    rows]}."""
    from hybridquantization_tpu_torch.ops import probe_kernels as pk
    from hybridquantization_tpu_torch.tools import kexp_assign, minidot_probe
    from hybridquantization_tpu_torch.tools import pack_pixels

    P = H * W
    rng = np.random.default_rng(0)  # vpu_assign_exp and kexp_assign draw alike
    feats = torch.as_tensor(rng.random((P, 3), dtype=np.float32), device=dev)
    pals = torch.as_tensor(rng.random((8, POP, K, 3)).astype(np.float32), device=dev)
    x4 = pack_pixels(feats)
    c4, o4 = pk.pack_palette(pals[0], pals[0])
    del feats, pals
    rng = np.random.default_rng(0)  # minidot_probe
    xm = torch.as_tensor(rng.random((4, P), dtype=np.float32), device=dev)
    cd = torch.as_tensor(rng.random((8, POP, 4, K), dtype=np.float32)[0], device=dev)
    kc, nr = minidot_probe.KC, minidot_probe.BLOCK // 128
    cm = {128: rng.random((8, POP, nr, 4, kc), dtype=np.float32)[:1],
          256: rng.random((8, POP, nr // 2, 4, kc), dtype=np.float32)[:1]}
    cr = {run: minidot_probe.per_run(torch.as_tensor(a, device=dev), P, run)[0] for run, a in cm.items()}
    rows = {"probe_kloop": [], "split_rowmax": [], "split_assign": []}

    def row(name_, variant, replaces, ms, plain_ms, b, **extra):
        rows[name_].append({"variant": variant, "replaces": replaces, "ms": ms, "plain_ms": plain_ms,
                            **b, **extra})
        print(f"probe {name_} {variant} 4K K={extra.get('K', K)} pop={POP}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}); "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in extra.items() if k != "K"))

    # T1, T2: bit for bit, every schedule against the one plain version
    vpu_at = "tools/vpu_assign_exp.py"
    (p_opp, p_counts), plain_s = _timed(lambda: pk.kloop_assign_reference(x4, c4, o4))
    for label, kw in (("T1 vpu", dict(slots=1, unroll=8)), ("T1 vpu_u4", dict(slots=1, unroll=4)),
                      ("T1 vpu_u16", dict(slots=1, unroll=16)),
                      ("T1 vpu_fused", dict(slots=1, fused=True, unroll=8)),
                      ("T2 grp8", dict(slots=8, unroll=1)), ("T2 grp8s2u4", dict(slots=8, unroll=4))):
        opp, counts = pk.kloop_assign(x4, c4, o4, **kw)
        colour = int((opp != p_opp).any(1).sum())
        count = int((counts - p_counts).abs().sum())
        if colour or count or not bool((counts.sum(1) == P).all()):
            fail(f"probe_kloop {label}: {colour} colour and {count} count mismatches against plain")
        ms = cuda_ms(lambda kw=kw: pk.kloop_assign(x4, c4, o4, **kw), 20)
        row("probe_kloop", label, f"{vpu_at}:{235 if label.startswith('T1') else 272}", ms, plain_s * 1e3,
            b1_bound(P, K, POP), max_abs_err=float((opp - p_opp).abs().max()), colour_mismatches=colour,
            count_mismatches=count)
    del opp, counts, p_opp, p_counts

    # T3, T5, T6 (and T4's dotmax, on T3's inputs): the split row max
    mini_at = "tools/minidot_probe.py"
    for label, replaces, x, c, run, bf in (
        ("T3 dotf32", f"{vpu_at}:342", x4, c4, None, False),
        ("T3 dotbf16", f"{vpu_at}:342", x4, c4, None, True),
        ("T4 dotmax", "tools/kexp_assign.py:271", x4, c4, None, False),
        ("T5 dense", f"{mini_at}:204", xm, cd, None, False),
        ("T6 mini128", f"{mini_at}:220", xm, cr[128], 128, False),
        ("T6 mini256", f"{mini_at}:220", xm, cr[256], 256, False),
    ):
        kw = dict(run=run, out_bf16=bf)
        if label == "T4 dotmax":
            kern = lambda x, c, o: kexp_assign.run_variant("dotmax", x, c, c)[0][:, 0]  # noqa: E731
        else:
            kern = lambda x, c, o, kw=kw: pk.split_rowmax(x, c, **kw)  # noqa: E731
        got, want, plain_ms = _versus(kern, lambda x, c, o, kw=kw: pk.split_rowmax_reference(x, c, **kw), x, c)
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        if bf:
            # the kernel rounds its own f32 maximum, within SPLIT_RTOL of the
            # plain one (dotf32's check): it may round the other way only
            # where a rounding boundary lies that close
            m = pk.split_rowmax_reference(x, c, run=run)
            d = SPLIT_RTOL * m.abs().clamp_min(1.0)
            outside = int(((got < pk.bf16_round(m - d)) | (got > pk.bf16_round(m + d))).sum())
            off = int((got != want).sum())
            if outside or off > BF16_OFF_SHARE * got.numel():
                fail(f"split_rowmax {label}: {outside} maxima are no rounding of a value within "
                     f"{SPLIT_RTOL} of the plain f32 maximum; {off} of {got.numel()} round the other "
                     f"way (limit {BF16_OFF_SHARE})")
            # and bit for bit the rounding of the kernel's own f32 maxima
            f32 = pk.split_rowmax(x, c, run=run)
            if not torch.equal(got, pk.bf16_round(f32)):
                fail(f"split_rowmax {label}: {int((got != pk.bf16_round(f32)).sum())} bf16 maxima are not "
                     "the rounding of the kernel's f32 maxima")
            del m, d, f32
        else:
            off = int(((got - want).abs() > SPLIT_RTOL * want.abs().clamp_min(1.0)).sum())
            if off:
                fail(f"split_rowmax {label}: {off} row maxima beyond {SPLIT_RTOL} (max rel {rel})")
        ms = cuda_ms(lambda x=x, c=c, kern=kern: kern(x, c, None), 20)
        extra = {}
        if label == "T5 dense":
            # informative: cuBLAS on the stacked bf16 operands plus a max, two calls
            xh, xl = pk.split2(x)
            ch, cl = pk.split2(c)
            x12 = torch.cat([xh, xl, xh]).T.to(torch.bfloat16).contiguous()
            c12 = torch.cat([ch, ch, cl], dim=1).to(torch.bfloat16).contiguous()
            extra["two_call_ms"] = cuda_ms(lambda: torch.matmul(x12, c12).amax(-1), 3, warmup=1)
            del x12, c12, xh, xl, ch, cl
            torch.cuda.empty_cache()
        kcs = c.shape[-1]
        row("split_rowmax", label, replaces, ms, plain_ms,
            split_bound(P, kcs, POP, 4.0 * (x.numel() + c.numel() + POP * P), 1),
            K=kcs, max_abs_err=float((got - want).abs().max()), max_rel_err=rel,
            mismatches=off if bf else 0, **({"rounded_other_way": off} if bf else {}), **extra)
        del got, want

    # T4 (every variant of kexp_assign at f32x3), `cur`, T7, T8: the split assignment
    checked = {}
    for tie_mode, parts, x, c, o, run, key in (("first", 3, x4, c4, o4, None, "T4"),
                                                ("average", 3, x4, c4, o4, None, "T4 avg"),
                                                ("first", 2, xm, cr[128], cr[128], 128, "T7 128"),
                                                ("first", 2, xm, cr[256], cr[256], 256, "T7 256")):
        kw = dict(run=run, tie_mode=tie_mode, opp_parts=parts, return_index=True)
        got, want, plain_ms = _versus(
            lambda x, c, o, kw=kw: pk.split_assign(x, c, o, **kw),
            lambda x, c, o, kw=kw: pk.split_assign_reference(x, c, o, **kw), x, c, o)
        (opp, counts, idx), (p_opp, p_counts, p_idx) = got, want
        n_idx = int((idx != p_idx).sum())
        differ = (idx != p_idx) | (opp != p_opp).any(1)
        n_off, gap, in_class = _split_near_ties(x, c, run, differ)
        if gap > NEAR_TIE_REL:
            fail(f"split_assign {key}: {n_off} pixels differ off the near-tie class (rel gap {gap})")
        # a differing pixel moves one count from one entry to another;
        # averaging, only the candidates of its near-tie class change their hits
        limit = 2 * n_off if tie_mode == "first" else in_class
        count = int((counts - p_counts).abs().sum())
        total = counts.sum(1)
        sums_ok = bool((total == P).all()) if tie_mode == "first" else bool((total >= P).all())
        if not sums_ok or count > limit:
            fail(f"split_assign {key}: {count} count mismatches for {n_off} differing pixels (limit "
                 f"{limit}), counts sum to {total.tolist()} ({P} px)")
        checked[key] = dict(plain_ms=plain_ms, index_mismatches=n_idx, max_rel_gap=gap, differing=n_off,
                            count_limit=limit, colour_mismatches=int((opp != p_opp).any(1).sum()),
                            count_mismatches=count,
                            max_abs_err=float((opp - p_opp).abs().max()), outs=(got, want), kc=c.shape[-1])
    kexp_at = "tools/kexp_assign.py:271"
    t4_bytes = 4.0 * (x4.numel() + 2 * c4.numel() + 4 * POP * P + POP * K)
    timed = {}
    for v in kexp_assign.VARIANTS:
        if v == "dotmax":
            continue  # a row max: split_rowmax's row
        base = checked["T4 avg" if v == "avg" else "T4"]
        (opp, counts, idx), (p_opp, p_counts, p_idx) = base["outs"]
        got = kexp_assign.run_variant(v, x4, c4, o4)
        want = kexp_assign.variant_outputs(v, p_opp, p_counts, p_idx)
        off_colour = int((got[0] != want[0]).any(1).sum())
        off_use = int((got[1].long() - want[1].long()).abs().sum())
        if off_colour > base["differing"] or off_use > base["count_limit"]:
            fail(f"kexp_assign {v}: {off_colour} colour and {off_use} usage mismatches for "
                 f"{base['differing']} near-tie pixels (usage limit {base['count_limit']})")
        # the schedules are one launch, timed once as `current`
        same = "current" if v in kexp_assign.SCHEDULES else v
        if same not in timed:
            timed[same] = cuda_ms(lambda v=v: kexp_assign.run_variant(v, x4, c4, o4), 20)
        row("split_assign", f"T4 {v}", kexp_at, timed[same], base["plain_ms"], split_bound(P, K, POP, t4_bytes, 2),
            **({"same_launch_as": f"T4 {same}"} if same != v else {}),
            **{k: base[k] for k in ("max_abs_err", "index_mismatches", "max_rel_gap", "count_mismatches")},
            colour_mismatches=off_colour, usage_mismatches=off_use)
    t4 = checked["T4"]
    ms = cuda_ms(lambda: pk.split_assign(x4, c4, o4), 20)  # writes no index: a launch of its own
    row("split_assign", "T4 cur (vpu_assign_exp)", kexp_at, ms, t4["plain_ms"],
        split_bound(P, K, POP, 4.0 * (x4.numel() + 2 * c4.numel() + 3 * POP * P + POP * K), 2),
        **{k: t4[k] for k in ("max_abs_err", "index_mismatches", "max_rel_gap", "colour_mismatches",
                              "count_mismatches")})
    for run in (128, 256):
        # T8 is T7's function: the same launch, timed once
        base, c = checked[f"T7 {run}"], cr[run]
        ms = cuda_ms(lambda c=c, run=run: pk.split_assign(xm, c, c, run=run, opp_parts=2), 20)
        b = split_bound(P, base["kc"], POP, 4.0 * (xm.numel() + 2 * c.numel() + 3 * POP * P + POP * base["kc"]), 2)
        same = {k: base[k] for k in ("max_abs_err", "index_mismatches", "max_rel_gap", "colour_mismatches",
                                     "count_mismatches")}
        row("split_assign", f"T7 minifull{run}", f"{mini_at}:252", ms, base["plain_ms"], b, K=base["kc"], **same)
        row("split_assign", f"T8 minifull2_{run}", f"{mini_at}:302", ms, base["plain_ms"], b, K=base["kc"],
            same_launch_as=f"T7 minifull{run}", **same)
    return rows


def phase_probe_paths() -> dict:
    """The three probe scripts' entry points on the card (python -m
    hybridquantization_tpu_torch.tools.<name>), each with every variant, the
    launch counts set to 0 just before and read just after: {path:
    {"launches": counts, "variants": {label: {"ms", "launches"}}}}."""
    from hybridquantization_tpu_torch.tools import kexp_assign, minidot_probe, vpu_assign_exp

    runs = {
        "vpu_assign_exp": (vpu_assign_exp.main, [
            "cur,vpu,vpu_u4,vpu_u16,vpu_fused,grp8,grp8s2u4,dotf32,dotbf16", "256"],
            ("probe_kloop", "split_rowmax", "split_assign")),
        "kexp_assign": (kexp_assign.main, [",".join(kexp_assign.VARIANTS), "256"],
                        ("split_rowmax", "split_assign")),
        "kexp_assign_highest": (kexp_assign.main, ["current", "256", "highest"], ("assign_pop",)),
        "minidot_probe": (minidot_probe.main, ["dense", "mini128", "mini256", "minifull128", "minifull256",
                                               "minifull2_128", "minifull2_256"],
                          ("split_rowmax", "split_assign")),
    }
    paths = {}
    for name_, (main_, argv, kernels) in runs.items():
        _reset_counts()
        t0 = time.perf_counter()
        out = main_(argv)
        torch.cuda.synchronize()
        launches = _counts()
        if any(launches[k] == 0 for k in kernels):
            fail(f"{name_} launched {launches}: each of {kernels} at least once")
        paths[name_] = {"launches": launches, "seconds": time.perf_counter() - t0,
                        "variants": {(k if isinstance(k, str) else k[1]): v for k, v in out.items()}}
        torch.cuda.empty_cache()
    return paths


def probe_kernel_rows(probes: dict, probe_paths: dict, by_path) -> list[dict]:
    """The probe kernels' rows of the kernels line: at top level their first
    variant, `launches` from the three probe scripts' paths, and each
    variant with the launches that script's run of it made."""
    script_of = {"T1": "vpu_assign_exp", "T2": "vpu_assign_exp", "T3": "vpu_assign_exp",
                 "T4": "kexp_assign", "T5": "minidot_probe", "T6": "minidot_probe",
                 "T7": "minidot_probe", "T8": "minidot_probe"}
    rows = []
    for name_, source in (("probe_kloop", "csrc/probe_kloop.cu"), ("split_rowmax", "csrc/split_assign.cu"),
                          ("split_assign", "csrc/split_assign.cu")):
        common = {"name": name_, "route": "cuda", "source": f"hybridquantization_tpu_torch/{source}"}
        variants = []
        for v in probes[name_]:
            t, label = v["variant"].split(" ")[:2]
            script = "vpu_assign_exp" if "(vpu_assign_exp)" in v["variant"] else script_of[t]
            run = probe_paths[script]["variants"][label]
            variants.append({**common, **v, "launches_from": script,
                             "launches": run["launches"][name_], "script_ms": run["ms"]})
        rows.append({**common, **variants[0], "variants": variants,
                     "launches": sum(r["launches"][name_] for r in probe_paths.values()),
                     "launches_by_path": by_path(name_)})
    return rows

def b2s_bound(H: int, Ws: int, taps: int, pop: int) -> dict:
    """B2s on a shard of Ws columns: B2's work at that width, plus the two
    guards' bytes (pop x 3 x H x taps // 2 floats each)."""
    return bound(2.0 * 2 * 7 * taps * pop * H * Ws,
                 4.0 * (3 * pop * H * Ws + 3 * H * Ws + 14 * taps + pop + 2 * pop * 3 * H * (taps // 2)))


def _b2s_args(q, target, kh, kv, lo: int, hi: int):
    """(args, guards) of B2s on columns [lo, hi) of the (pop, 3, H, W) q:
    the guards are the columns beyond the shard, mirrored at the frame's
    borders (parallel.fast._column_guards across ranks)."""
    from hybridquantization_tpu_torch import colorspace as cs

    half, W = kh.shape[1] // 2, q.shape[-1]
    left = q[..., lo - half:lo] if lo else q[..., :half].flip(-1)
    right = q[..., hi:hi + half] if hi < W else q[..., hi - half:hi].flip(-1)
    args = (q[..., lo:hi].contiguous(), target[..., lo:hi].contiguous(), kh, kv, cs.WHITEPOINT_D65, "CIE76")
    return args, {"left_slab": left.contiguous(), "right_slab": right.contiguous()}


def phase_mesh_b2s(img, opp, dev) -> list[dict]:
    """(a) B2s at 4K/pop4 on B1's winners over 2 and 4 shards of the column
    plan: each shard's sums twice (bit-equal) and against the plain version
    (B2_RTOL), the shards' total against whole-image B2 (B2_RTOL), each
    shard timed (CUDA events) beside mirror B2 on its width."""
    from hybridquantization_tpu_torch import QuantizationConfig
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.parallel import plan_fast
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters

    (h, w, _), pop = img.shape, opp.shape[0]
    ctx = _make_context(img, build_filters(), QuantizationConfig(), dev)
    kh, kv, target = ctx["kh"], ctx["kv"], ctx["target_planar"]
    host = {"taps_on_host": ctx["taps_on_host"]}
    taps = kh.shape[1]
    q = opp.reshape(pop, 3, h, w)
    whole = ff.fused_scielab_err_sums(q, target, kh, kv, cs.WHITEPOINT_D65, "CIE76", **host).double()
    rows = []
    for n in MESH_SHARDS:
        cols, ok = plan_fast(h, w, taps // 2, n)
        if not ok:
            fail(f"column plan of {w}x{h} over {n} shards infeasible")
        shards, total = [], torch.zeros_like(whole)
        for lo, hi in cols:
            args, guards = _b2s_args(q, target, kh, kv, lo, hi)
            got = ff.fused_scielab_err_sums(*args, **guards, **host)
            again = ff.fused_scielab_err_sums(*args, **guards, **host)
            want = ff.fused_scielab_err_sums_reference(*args, **guards)
            torch.cuda.synchronize()
            rel = ((got.double() - want.double()).abs() / want.double().abs()).max().item()
            if not (torch.equal(got, again) and bool(torch.isfinite(got).all()) and rel <= B2_RTOL):
                fail(f"B2s shard [{lo}, {hi}) of {n}: {got.tolist()} (again {again.tolist()}) vs plain "
                     f"{want.tolist()}: rel {rel}")
            total += got.double()
            ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **guards, **host), 20)
            mirror_ms = cuda_ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20)
            plain_ms = cuda_ms(lambda: ff.fused_scielab_err_sums_reference(*args, **guards), 3, warmup=1)
            shards.append({"cols": [lo, hi], "ms": ms, "mirror_ms": mirror_ms, "plain_ms": plain_ms,
                           "max_abs_err": float((got - want).abs().max()), "max_rel_err": rel,
                           **b2s_bound(h, hi - lo, taps, pop)})
        total_rel = ((total - whole).abs() / whole.abs()).max().item()
        if total_rel > B2_RTOL:
            fail(f"B2s over {n} shards: total {total.tolist()} vs whole-image B2 {whole.tolist()}")
        mean = {k: sum(r[k] for r in shards) / n for k in ("ms", "mirror_ms", "plain_ms")}
        print(f"B2s fused_fitness slabs {w}x{h} pop={pop} over {n} shards of {cols[0][1] - cols[0][0]} columns: "
              f"per shard kernel {', '.join(f'{r['ms']:.3f}' for r in shards)} ms (mirror B2 on the same width "
              f"{', '.join(f'{r['mirror_ms']:.3f}' for r in shards)} ms), plain "
              f"{', '.join(f'{r['plain_ms']:.3f}' for r in shards)} ms, bound {shards[0]['bound_ms']:.3f} ms "
              f"({shards[0]['bound_by']}); max rel diff from plain "
              f"{max(r['max_rel_err'] for r in shards):.3g} <= {B2_RTOL}; shards' total vs whole-image B2 "
              f"{total_rel:.3g}")
        rows.append({"variant": f"slabs, {n} shards", "shards": n,
                     "shape": f"{cols[0][1] - cols[0][0]}x{h} per shard of {w}x{h}", "pop": pop,
                     "max_abs_err": max(r["max_abs_err"] for r in shards),
                     "max_rel_err": max(r["max_rel_err"] for r in shards), "total_rel_err": total_rel,
                     **mean, **{k: shards[0][k] for k in ("bound_ms", "bound_by", "library_ms")},
                     "per_shard": shards})
    return rows


def _fixed_palettes(device) -> torch.Tensor:
    """(1, POP, K, 3) palettes for the mesh's fitness check, the same everywhere."""
    return torch.rand((1, POP, K, 3), generator=torch.Generator().manual_seed(7)).to(device)


def _rank_counts() -> dict:
    from hybridquantization_tpu_torch.ops import fused_fitness as ff

    return {**_counts(), "fused_fitness_slabs": ff.fused_scielab_err_sums.slab_launches}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_engine_rank(rank, frame_path, shape, device) -> dict:
    """(b)/(d): one rank of ShardedBatchQuantizer (columns) on the 4K frame,
    the quality schedule with its counts set to 0 just before and read just
    after, then its fitness of the fixed palettes."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.parallel import ShardedBatchQuantizer, make_mesh

    n_data, n_pop, n_pixel = shape
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX), init="kmeans")
    q = ShardedBatchQuantizer(cfg, make_mesh(n_data, n_pixel, n_pop, device), strategy="columns")
    images = torch.as_tensor(np.load(frame_path)[None], device=q.device)
    _sync(q.device)
    _reset_counts()
    t0 = time.perf_counter()
    out, info = q.run(images, polish_iters=POLISH)
    de, _ = q.error_images(images, out)
    _sync(q.device)
    secs = time.perf_counter() - t0
    launches = _rank_counts()
    err, use = q._columns[0](images)(_fixed_palettes(q.device))
    return {"palettes": info["palettes"].cpu().numpy(), "best_errors": info["best_errors"],
            "telemetry": info["telemetry"]["best_error"], "de": de.cpu().numpy(),
            "out_sha": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(),
            "colours": len(torch.unique(out.reshape(-1, 3), dim=0)), "err": err.cpu().numpy(),
            "use": use.cpu().numpy(), "launches": launches, "seconds": secs, "anneal_seconds": info["seconds"],
            "device": str(q.device), "backend": q.mesh.backend}


def _mesh_small_rank(rank, frames_path, device) -> dict:
    """(c): one of 4 gloo ranks: rows and columns on (1, 1, 2) (ranks 0 and
    1), the pop axis on (1, 2, 2), data on (2, 1, 1) (ranks 0 and 1), each
    find_palettes with the counts set to 0 just before and read just after."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.parallel import ShardedBatchQuantizer, make_mesh

    frames = np.load(frames_path)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=MESH_IMAX), init="kmeans")
    line, pop, data = (make_mesh(1, 2, 1, device), make_mesh(1, 2, 2, device), make_mesh(2, 1, 1, device))
    out = {}

    def run(name, mesh, strategy, images):
        q = ShardedBatchQuantizer(cfg, mesh, strategy=strategy)
        images = torch.as_tensor(images, device=q.device)
        _sync(q.device)
        _reset_counts()
        pals, info = q.find_palettes(images)
        _sync(q.device)
        out[name] = {"palettes": pals.cpu().numpy(), "best_errors": info["best_errors"],
                     "launches": _rank_counts(), "seconds": info["seconds"]}

    if line.member:
        run("rows", line, "rows", frames[:1])
        run("columns", line, "columns", frames[:1])
    run("pop", pop, "columns", frames[:1])
    if data.member:
        run("data", data, "auto", frames)
    return out


def _agree(ranks: list, what: str, skip=("seconds", "anneal_seconds", "device")) -> None:
    """Fail unless every rank's results equal rank 0's, bit for bit."""
    for r, res in enumerate(ranks[1:], 1):
        for k, v in res.items():
            if k in skip:
                continue
            if isinstance(v, dict):
                _agree([ranks[0][k], v], f"{what} {k}", skip)
            elif not np.array_equal(np.asarray(v), np.asarray(ranks[0][k])):
                fail(f"{what}: rank {r} differs from rank 0 in {k}")


def _engine_against_one_device(ranks, img, dev, label) -> dict:
    """(b)/(d): the mesh's fitness of the fixed palettes and its anneal
    against BatchQuantizer's on the same frame and seed."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.parallel import BatchQuantizer
    from hybridquantization_tpu_torch.pipeline import _make_batch_context, make_population_fitness

    _agree(ranks, label)
    r0 = ranks[0]
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX), init="kmeans")
    bq = BatchQuantizer(cfg, device=dev)
    images = torch.as_tensor(img[None], device=dev)
    err, use = make_population_fitness(_make_batch_context(images, bq.filters, cfg, dev), cfg)(_fixed_palettes(dev))
    fit_rel = float(np.max(np.abs(r0["err"].astype(np.float64) - err.cpu().numpy()) / err.cpu().numpy()))
    if fit_rel > FIT_RTOL or not np.array_equal(r0["use"], use.cpu().numpy()):
        fail(f"{label}: fitness of fixed palettes {r0['err'].tolist()} vs one device {err.tolist()} "
             f"(rel {fit_rel}), usage equal {np.array_equal(r0['use'], use.cpu().numpy())}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, info = bq.run(images, polish_iters=POLISH)
    de, _ = bq.error_images(images, out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    de_rel = float(r0["de"][0]) / float(de[0]) - 1
    want = {"assign_pop": POP * (1 + QS_IMAX), "fused_fitness": POP * (1 + QS_IMAX),
            "fused_fitness_slabs": POP * (1 + QS_IMAX), "assign_idx": 1, "lloyd_step": LLOYD_RUN,
            **OFF_ENGINE}
    if r0["launches"] != want:
        fail(f"{label}: each rank launched {r0['launches']}, not {want}")
    if abs(de_rel) > MESH_DE_REL or r0["colours"] > K:
        fail(f"{label}: mean dE {float(r0['de'][0])} vs one device {float(de[0])}, {r0['colours']} colours")
    traj, one = r0["telemetry"][:, 0], info["telemetry"]["best_error"][:, 0]
    steps = sorted({min(s, QS_IMAX - 1) for s in (0, 9, 24, QS_IMAX - 1)})
    print(f"{label}: {len(ranks)} ranks ({r0['backend']} on {', '.join(r['device'] for r in ranks)}) bit-equal; "
          f"fitness of fixed palettes within {fit_rel:.3g} (<= {FIT_RTOL}) of one device, usage equal; quality "
          f"schedule {r0['seconds']:.3f} s (anneal {r0['anneal_seconds']:.3f} s, "
          f"{r0['anneal_seconds'] / QS_IMAX:.4f} s/iter) vs one device {secs:.3f} s (anneal {info['seconds']:.3f} s); "
          f"best fitness after iterations {[s + 1 for s in steps]}: mesh {[float(traj[s]) for s in steps]}, one "
          f"device {[float(one[s]) for s in steps]}; mean S-CIELAB dE {float(r0['de'][0]):.5f} vs "
          f"{float(de[0]):.5f} ({100 * de_rel:+.3f}%, limit {100 * MESH_DE_REL:.0f}%); launches per rank "
          f"{r0['launches']}")
    return {"ranks": len(ranks), "backend": r0["backend"], "seconds": r0["seconds"],
            "anneal_s_per_iter": r0["anneal_seconds"] / QS_IMAX, "one_device_seconds": secs,
            "one_device_anneal_s_per_iter": info["seconds"] / QS_IMAX, "mean_de": float(r0["de"][0]),
            "one_device_mean_de": float(de[0]), "fitness_rel": fit_rel, "launches": r0["launches"]}


def phase_mesh(img, dev) -> dict:
    """(b), (c) and (d) of the module doc. Returns their numbers and each
    path's per-rank launches."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.parallel import BatchQuantizer
    from hybridquantization_tpu_torch.parallel.multihost import launch

    cards = torch.cuda.device_count()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        frame, frames = os.path.join(tmp, "frame.npy"), os.path.join(tmp, "frames.npy")
        np.save(frame, img)
        small = np.stack([img[:MESH_H, :MESH_W], img[-MESH_H:, -MESH_W:]])
        np.save(frames, small)
        print(f"mesh (b): 2 gloo ranks sharing card 0 ({torch.cuda.get_device_name(0)}; {cards} card(s)); "
              "their collectives go through the host")
        t0 = time.perf_counter()
        card0 = "cuda:0" if dev.type == "cuda" else "cpu"
        ranks = launch(_mesh_engine_rank, 2, (frame, (1, 1, 2), card0), device=dev.type, backend="gloo")
        res["columns_4k"] = _engine_against_one_device(
            ranks, img, dev, f"mesh (b) columns 1x1x2 {W}x{H} K={K} pop={POP} kmeans imax={QS_IMAX} polish {POLISH}")
        res["columns_4k"]["launch_seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ranks = launch(_mesh_small_rank, 4, (frames, dev.type), device=dev.type, backend="gloo")
        for name in ("rows", "columns", "pop", "data"):
            _agree([r[name] for r in ranks if name in r], f"mesh (c) {name}")
        got = ranks[0]
        for k in ("palettes", "best_errors"):
            if not np.array_equal(got["pop"][k], got["columns"][k]):
                fail(f"mesh (c): the pop axis (1x2x2) differs from (1x1x2) in {k}")
        cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=MESH_IMAX), init="kmeans")
        pals, info = BatchQuantizer(cfg, device=dev).find_palettes(small)
        if not (np.array_equal(got["data"]["palettes"], pals.cpu().numpy())
                and np.array_equal(got["data"]["best_errors"], info["best_errors"])):
            fail("mesh (c): the data axis (2x1x1) differs from the one-device engine")
        rows_rel = float(got["rows"]["best_errors"][0] / got["columns"]["best_errors"][0] - 1)
        if abs(rows_rel) > MESH_DE_REL:
            fail(f"mesh (c): rows best fitness {got['rows']['best_errors']} vs columns {got['columns']['best_errors']}")
        print(f"mesh (c) {MESH_W}x{MESH_H} K={K} pop={POP} kmeans imax={MESH_IMAX}, 4 gloo ranks on card 0: "
              f"pop axis 1x2x2 bit-equal to 1x1x2 columns (best {got['pop']['best_errors'].tolist()}); data 2x1x1 "
              f"bit-equal to BatchQuantizer (best {got['data']['best_errors'].tolist()}); rows 1x1x2 best "
              f"{got['rows']['best_errors'].tolist()} ({100 * rows_rel:+.3f}% from columns); anneal s: "
              + ", ".join(f"{n} {got[n]['seconds']:.3f}" for n in ("rows", "columns", "pop", "data"))
              + "; launches per rank (rank 0): "
              + "; ".join(f"{n} {got[n]['launches']}" for n in ("rows", "columns", "pop", "data")))
        res["small"] = {n: {"seconds": got[n]["seconds"], "launches": got[n]["launches"],
                            "best_errors": got[n]["best_errors"].tolist()} for n in ("rows", "columns", "pop", "data")}
        res["small"]["launch_seconds"] = time.perf_counter() - t0

        if cards >= 2:
            from hybridquantization_tpu_torch.tools.bench_multichip import measure_scaling

            ranks = launch(_mesh_engine_rank, 2, (frame, (1, 1, 2), "cuda"), device="cuda", backend="nccl")
            res["nccl"] = _engine_against_one_device(ranks, img, dev, "mesh (d) NCCL columns 1x1x2, one rank per card")
            res["scaling"] = measure_scaling([n for n in (1, 2, 4, 8) if n <= cards], H, W, K, POP, iters=10,
                                             reps=3, log=lambda line: print(f"mesh (d) scaling {line}"))
        else:
            print(f"mesh (d) not run: {cards} card; NCCL needs one card per rank, and (b) and (c) share the card "
                  "under gloo")
    return res


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
    b2_split = phase_b2_split(img, opp, dev)
    b2_paths = phase_b2_paths(dev)
    b2s = phase_mesh_b2s(img, opp, dev)
    b3, lloyd = phase_b3(_b3_cases(img_dev, pals, cli_dev))
    del opp, cli_opp, cli_dev
    torch.cuda.empty_cache()
    b1_fast, b2_fast = phase_fast_kernels(img, img_dev, pals, dev)
    del img_dev
    torch.cuda.empty_cache()
    phase_small_slice(dev)
    phase_small_polish(dev)
    parity = phase_parity()
    f32x3, f32x3_row, f32x3_b2_row = phase_tpu_f32x3(dev)
    launches, random_de = phase_e2e(img, dev)
    quality, exact = phase_quality_schedule(img, dev, random_de)
    cli_counts = phase_cli(dev)
    fast = phase_fast_schedule(img, dev)
    torch.cuda.empty_cache()
    batch = phase_batch(dev)
    torch.cuda.empty_cache()
    probes = phase_probes(dev)
    torch.cuda.empty_cache()
    probe_paths = phase_probe_paths()
    torch.cuda.empty_cache()
    mesh = phase_mesh(img, dev)
    # each kernel: at top level, its check and times at the largest bucket of
    # the batch path (quantize-batch --fast over the 64 images) and
    # `launches` from that path; every bucket under "main_path"; the 4K
    # variants under "variants", each with the launches of the 4K path that
    # runs it ("launches_from"; 0 where no path does); the other shapes
    # under "checks"; every path's own counts under "launches_by_path"
    runs_at_4k = {"srgb f32x3 first": "quality_schedule", "f32x3": "quality_schedule",
                  "srgb bf16 average": "fast_schedule", "bf16": "fast_schedule"}
    path_counts = {"quality_schedule": quality, "fast_schedule": fast}

    def at_4k(name_, v):
        if v["variant"].startswith("slabs"):
            # B2s: the per-rank launches of the 4K mesh path (b), 2 shards
            return {"launches_from": "mesh_columns_4k_per_rank",
                    "launches": mesh["columns_4k"]["launches"]["fused_fitness_slabs"]}
        path = runs_at_4k.get(v["variant"])
        return {"launches_from": path, "launches": path_counts[path][name_] if path else 0}

    mesh_paths = {"mesh_columns_4k_per_rank": mesh["columns_4k"]["launches"],
                  **{f"mesh_{n}_1080p_per_rank": mesh["small"][n]["launches"]
                     for n in ("rows", "columns", "pop", "data")},
                  **({"mesh_nccl_columns_4k_per_rank": mesh["nccl"]["launches"]} if "nccl" in mesh else {})}

    def by_path(name_):
        return {**{path: counts[name_] for path, counts in mesh_paths.items()},
                "e2e_random_imax30": launches[name_], "fitness_parity_config1": parity[name_],
                "tpu_f32x3_config1": f32x3[name_],
                "quality_schedule": quality[name_],
                "exact_polish_4k": exact[name_], "cli_quantize": cli_counts[name_],
                "fast_schedule": fast[name_], "quantize_batch_64": batch["launches"][name_],
                "cli_quantize_batch_4": batch["cli_launches"][name_],
                **{path: r["launches"][name_] for path, r in probe_paths.items()}}

    kernels = []
    for name_, source, replaces, variants, checks in (
        ("assign_pop", "csrc/assign_pop.cu", "ops/pallas_assign.py:371",
         [{"variant": "srgb f32x3 first", **b1}, *b1_fast], [b1_cli]),
        ("fused_fitness", "csrc/fused_fitness.cu", "ops/fused_fitness.py:597",
         [{"variant": "f32x3", **b2}, *b2_fast, *b2s, *b2_paths], [b2_cli]),
        ("assign_idx", "csrc/assign_idx.cu", "ops/pallas_assign.py:420", [], b3),
        # the index kernel with the segment sums JAX takes beside it (ops/assign.py:175-176)
        ("lloyd_step", "csrc/assign_idx.cu", "ops/pallas_assign.py:420", [], lloyd),
    ):
        common = {"name": name_, "route": "cuda",
                  "source": f"hybridquantization_tpu_torch/{source}",
                  "replaces": f"hybridquantization_tpu/{replaces}"}
        main_path = [b["kernels"][name_] for b in batch["buckets"]]
        largest = max(main_path, key=lambda r: r["bucket_pixels"])
        kernels.append({
            **common, **largest, "launches": batch["launches"][name_], "main_path": main_path,
            "variants": [{**common, **v, **at_4k(name_, v)} for v in variants],
            "checks": checks, "launches_by_path": by_path(name_),
        })
    kernels += probe_kernel_rows(probes, probe_paths, by_path)
    # split_assign also runs on the f32x3 emulation's path (C2's diagnostics)
    split_row = next(r for r in kernels if r["name"] == "split_assign")
    split_row["variants"].append({**{k: split_row[k] for k in ("name", "route", "source")}, **f32x3_row})
    split_row["launches"] += f32x3["split_assign"]
    # B2's split mode, the TPU kernel's f32x3: its numbers at the shape of the
    # emulation's path (config-1), launches from that path; 4K under "checks"
    kernels.append({"name": "fused_fitness_f32x3", "route": "cuda",
                    "source": "hybridquantization_tpu_torch/csrc/fused_fitness.cu",
                    "replaces": "hybridquantization_tpu/ops/fused_fitness.py:597", **f32x3_b2_row,
                    "checks": [b2_split], "launches_by_path": by_path("fused_fitness_split")})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
