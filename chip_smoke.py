#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`hybridquantization_tpu_torch/csrc/` (one nvcc per source, in parallel),
holds each against its plain torch version at the shapes the paths below
give it (B1 and B2: a 3840x2160 frame at K=256 and a 1024x768 frame at
K=64, population 4; B3 on one palette: both frames in sRGB and in LAB, and
the 2^15- and 2^18-bin colour histograms of the k-means seeding and the
histogram polish), checks the annealing slice and the exact Lloyd polish
against the plain path on small inputs, then drives three paths at full
width, each with the launch counts set to 0 just before it and read just
after:

  e2e               random init, imax=30: `HybridQuantizer(...).run` and
                    `error_image` (B1, B2; B3 in quantize);
  quality schedule  k-means seeds, imax=50, `.polish` (histogram at 4K),
                    `quantize`, `error_image` (B1, B2; B3 in every Lloyd
                    step and quantize), then the exact polish at 4K (B3);
  cli               `cli.main(["quantize", ...])` on a 1024x768 `.ppm` with
                    every flag of the flow (exact polish through B3), a
                    resumed second run from its checkpoint, and `error`.

Each phase prints one line. Before the last line it prints the card's name
and power limit and a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
so does a machine without a CUDA device.

Imports torch, numpy, the standard library and the port; never jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

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
            "index_mismatches": n_diff, "max_score_gap": max_gap, "ms": ms, "plain_ms": plain_ms}, opp


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
            "ms": ms, "plain_ms": plain_ms}


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
                    "max_rel_gap": rel, "index_mismatches": n_diff, "ms": ms, "plain_ms": plain_ms})
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


def phase_quality_schedule(img, dev, random_de: float) -> tuple[dict, dict]:
    """The flow bench.py times, at 4K/K256/pop4: k-means seeds, 50 SWASA
    iterations, 10 Lloyd polish steps (the histogram path at 4K), quantize,
    error_image; then the exact polish at 4K. B3 runs in every Lloyd step
    of the seeding and the polish and in both quantize passes (the run's
    own and the final one)."""
    from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.ops import assign as assign_ops
    from hybridquantization_tpu_torch.ops.kmeans import kmeans_init_palettes
    from hybridquantization_tpu_torch.pipeline import _make_context

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=QS_IMAX),
                             init="kmeans")
    _reset_counts()

    def run():
        q = HybridQuantizer(cfg, device=dev)
        return q, q.run(img)[1]

    (q, info), t_run = _timed(run)
    palette, t_polish = _timed(lambda: q.polish(img, info["palette"], POLISH))
    out, t_quant = _timed(lambda: q.quantize(img, palette))
    (mean, viz), t_err = _timed(lambda: q.error_image(img, out))
    launches = _counts()
    e2e = t_run + t_polish + t_quant + t_err
    want = {"assign_pop": 1 + QS_IMAX, "fused_fitness": 1 + QS_IMAX,
            "assign_idx": SEED_STEPS + 1 + POLISH + 1}
    if launches != want:
        fail(f"the schedule launched {launches}, not {want}")
    n_colors = len(torch.unique(out.reshape(-1, 3), dim=0))
    if not (torch.isfinite(mean) and bool(torch.isfinite(out).all())) or n_colors > K:
        fail(f"quality schedule: mean dE {float(mean)}, {n_colors} colours")
    if out.shape != (H, W, 3) or viz.shape != (H, W, 3):
        fail(f"quality schedule output {tuple(out.shape)}")
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
          f"polish: {e2e:.3f} s end to end (run {t_run:.3f} s of which anneal "
          f"{info['seconds']:.3f} s; polish {t_polish:.3f} s, quantize {t_quant:.3f} s, "
          f"error_image {t_err:.3f} s; warm repeats: context {t_ctx:.3f} s, k-means seeding "
          f"{t_seed:.3f} s); best fitness {info['best_error']:.5f}, mean S-CIELAB dE "
          f"{float(mean):.5f} (random init imax={IMAX}: {random_de:.5f}), {n_colors} colours; "
          f"launches {launches}; exact polish {t_exact:.3f} s, B3 launched {b3} times, dE after "
          f"exact polish {float(mean_exact):.5f} vs hist polish {float(mean):.5f}")
    return launches, exact_launches


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
    del opp, cli_opp, img_dev, cli_dev
    torch.cuda.empty_cache()
    phase_small_slice(dev)
    phase_small_polish(dev)
    launches, random_de = phase_e2e(img, dev)
    quality, exact = phase_quality_schedule(img, dev, random_de)
    cli_counts = phase_cli(dev)
    # each kernel: its 4K check's numbers, the other shapes under "checks",
    # `launches` from the quality schedule and every path's own counts
    kernels = []
    for name_, source, replaces, checks in (
        ("assign_pop", "csrc/assign_pop.cu", "ops/pallas_assign.py:371", [b1, b1_cli]),
        ("fused_fitness", "csrc/fused_fitness.cu", "ops/fused_fitness.py:597", [b2, b2_cli]),
        ("assign_idx", "csrc/assign_idx.cu", "ops/pallas_assign.py:420", b3),
    ):
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"hybridquantization_tpu_torch/{source}",
            "replaces": f"hybridquantization_tpu/{replaces}",
            "launches": quality[name_], **checks[0], "checks": checks[1:],
            "launches_by_path": {"e2e_random_imax30": launches[name_],
                                 "quality_schedule": quality[name_],
                                 "exact_polish_4k": exact[name_],
                                 "cli_quantize": cli_counts[name_]},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
