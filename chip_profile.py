#!/usr/bin/env python3
"""Stage split and device profile of the 4K quality schedule, or of the
64-image batch, on one GPU.

    python3 chip_profile.py [--trace PATH]
    python3 chip_profile.py --batch [--inputs DIR] [--trace PATH]

Run from the root of a checkout, on a machine with a CUDA device. The
schedule is `chip_smoke.py`'s quality schedule, the flow `bench.py` times:
a 3840x2160 `synth.natural_image` (seed 0), K=256, population 4, k-means
seeds, 50 SWASA iterations, 10 Lloyd polish steps (the histogram path at
4K), quantize, error_image. The exact Lloyd polish at 4K is timed beside
it. The stages are `HybridQuantizer.find_palette`'s, called one by one in
its order.

1. Stage split: three runs of the schedule in one process, each stage
   between two `torch.cuda.synchronize()`, seconds by host clock. The
   first run is cold (allocation, the first launch of each kernel).
2. Profile: one more (warm) run under `torch.profiler` with CUDA activity.
   From its Chrome trace: device busy time (the union of the intervals of
   kernels, copies and memsets), the span from the first device event's
   start to the last one's end, the idle share 1 - busy / span, and device
   time and launches by kernel name.

With --batch, the run is `chip_smoke.py`'s batch phase instead:
`quantize-batch --fast --init kmeans --imax 50 --polish 10 --error-images`
at K=256, pop 4 over 64 natural images (16 each of 1920x1080, 1280x720,
1024x768 and 640x480, image i from seed i, through an 8-bit PPM as the
command reads them) on the engine and bucketing the command uses
(`parallel.BatchQuantizer`, `batching.run_bucketed`). Each bucket's stages
run one by one in `BatchQuantizer.run`'s order, each between two
synchronizations: k-means seeding (histogram + Lloyd steps), context (the
targets' S-CIELAB), anneal (initial fitness + 50 iterations), polish,
quantize, error images. Two runs of the 64 (the first cold), then one more
under the profiler. `--inputs DIR` keeps the 64 PPMs in DIR and reuses them
on the next call (making them takes most of a minute on 8 processes).

Prints the card's name and power limit, a table of each, and a JSON object
as the last line. Writes no file but the trace, and that only with
`--trace PATH` (and the inputs, with `--inputs`). Imports torch, numpy,
the standard library and the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W, K, POP, IMAX, POLISH = 2160, 3840, 256, 4, 50, 10
RUNS = 3  # stage-split runs: one cold, two warm
TOP = 15  # kernels listed by device time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def schedule(img, dev, stage) -> dict:
    """One run of the quality schedule; `stage(name, fn)` runs and times fn."""
    from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.ops.assign import polish_palette
    from hybridquantization_tpu_torch.ops.kmeans import kmeans_init_palettes
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.swasa import loop

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=IMAX),
                             init="kmeans")

    def engine():
        q = HybridQuantizer(cfg, device=dev)
        return q, q._as_image(img)

    q, image = stage("engine (filters, host) + upload", engine)
    pixels = image.reshape(-1, 3)
    ctx = stage("context (target S-CIELAB)", lambda: _make_context(image, q.filters, cfg, dev))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    seeds = stage("k-means seeding", lambda: kmeans_init_palettes(gen, pixels, K, POP))
    fitness = make_population_fitness(ctx, cfg)
    state = stage("initial fitness", lambda: loop.init_state(gen, fitness, cfg.swasa, seeds))

    def anneal(state=state):
        for _ in range(IMAX // cfg.progress_every):
            state, _ = loop.run_chunk(state, fitness, cfg.swasa, cfg.progress_every)
        return state

    state = stage(f"anneal, {IMAX} iterations", anneal)
    palette = stage(f"histogram polish, {POLISH} steps",
                    lambda: q.polish(image, state.best_colors, POLISH))
    out = stage("quantize", lambda: q.quantize(image, palette))
    mean, _ = stage("error_image", lambda: q.error_image(image, out))
    stage(f"(aside) exact polish, {POLISH} steps", lambda: polish_palette(
        pixels, state.best_colors, "srgb", q._whitepoint, POLISH, method="exact"))
    return {"best_error": float(state.best_error), "mean_de": float(mean)}


def stage_split(img, dev, runs: int) -> list[dict]:
    splits = []
    for _ in range(runs):
        secs = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return out

        quality = schedule(img, dev, stage)
        splits.append({"seconds": secs, **quality})
    return splits


def batch_inputs(inputs: str | None) -> list:
    """The batch phase's 64 images: written as PPMs by a pool of processes
    (chip_smoke._write_ppm), read back as the command reads them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke as cs
    from hybridquantization_tpu_torch import native

    with tempfile.TemporaryDirectory() as tmp:
        folder = inputs or tmp
        os.makedirs(folder, exist_ok=True)
        jobs = [(os.path.join(folder, f"im{i:02d}_{w}x{h}.ppm"), h, w, i)
                for i, (h, w) in ((i, cs.BATCH_SIZES[i % 4]) for i in range(cs.BATCH_IMAGES))]
        todo = [j for j in jobs if not os.path.exists(j[0])]
        if todo:
            with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                list(ex.map(cs._write_ppm, todo))
        return [native.load_image(j[0]) for j in jobs]


def batch(images, dev, stage) -> list[dict]:
    """The 64 images bucket by bucket, as chip_smoke's batch phase runs them;
    `stage(bucket, name, fn)` runs and times fn. Per bucket: its shape and
    mean S-CIELAB dE."""
    import chip_smoke as cs
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.batching import run_bucketed
    from hybridquantization_tpu_torch.parallel import BatchQuantizer
    from hybridquantization_tpu_torch.parallel.batch import _anneal, _init_colors, _seeds
    from hybridquantization_tpu_torch.pipeline import _make_batch_context, make_population_fitness
    from hybridquantization_tpu_torch.swasa import loop

    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=cs.K, population=cs.POP, imax=cs.QS_IMAX),
                             init="kmeans", precision="bf16", tie_mode="average")
    engine = BatchQuantizer(cfg, device=dev)
    buckets = []

    def run(stack):
        n, h, w, _ = stack.shape
        name = f"{w}x{h}"
        images = stage(name, "upload", lambda: engine._images(stack))
        gens = tuple(torch.Generator(device=dev).manual_seed(s) for s in _seeds(None, n, cfg))
        init = stage(name, "k-means seeding", lambda: _init_colors(gens, images, cfg))
        ctx = stage(name, "context", lambda: _make_batch_context(images, engine.filters, cfg, dev))
        fitness = make_population_fitness(ctx, cfg)

        def anneal():
            state = loop.init_state(gens, fitness, cfg.swasa, init)
            return _anneal(state, fitness, cfg, None, None)[0]

        state = stage(name, "anneal", anneal)
        pals = stage(name, "polish", lambda: engine.polish(images, state.best_colors, cs.POLISH))
        out = stage(name, "quantize", lambda: engine.quantize(images, pals))
        de, _ = stage(name, "error images", lambda: engine.error_images(images, out))
        buckets.append({"bucket": name, "images": n, "mean_de": float(de.mean())})
        return (np.zeros(n),)

    run_bucketed(images, run)
    return buckets


def batch_split(images, dev, runs: int) -> list[dict]:
    splits = []
    for _ in range(runs):
        secs = {}

        def stage(bucket, name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.setdefault(bucket, {})[name] = time.perf_counter() - t0
            return out

        buckets = batch(images, dev, stage)
        splits.append({"seconds": secs, "buckets": buckets})
    return splits


def device_profile(run, trace: str | None) -> dict:
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"], e["cat"])
        for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )
    if not device:
        raise RuntimeError("the trace holds no device event")
    busy, cur_lo, cur_hi = 0.0, device[0][0], device[0][1]
    for lo, hi, _, _ in device[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    span = max(hi for _, hi, _, _ in device) - device[0][0]
    by_name = {}
    for lo, hi, name, _ in device:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (hi - lo) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_events": len(device), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span,
            "by_kernel": [{"name": n, "ms": ms, "launches": c} for n, (ms, c) in top]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", metavar="PATH", help="also keep the Chrome trace at PATH")
    parser.add_argument("--batch", action="store_true", help="the 64-image batch instead of the 4K schedule")
    parser.add_argument("--inputs", metavar="DIR", help="with --batch: keep (and reuse) the 64 PPMs in DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.synth import natural_image

    dev = setup_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.batch:
        t0 = time.perf_counter()
        images = batch_inputs(args.inputs)
        print(f"inputs: {len(images)} images in {time.perf_counter() - t0:.1f} s (host)")
        splits = batch_split(images, dev, RUNS - 1)
        print(f"stage seconds by bucket, {len(splits)} runs of the 64 (first cold):")
        totals = [0.0] * len(splits)
        for bucket in splits[0]["seconds"]:
            for name in splits[0]["seconds"][bucket]:
                row = [s["seconds"][bucket][name] for s in splits]
                totals = [t + r for t, r in zip(totals, row)]
                print(f"  {bucket:10s} {name:18s} " + " ".join(f"{r:.6f}" for r in row))
            bucket_totals = [sum(s["seconds"][bucket].values()) for s in splits]
            print(f"  {bucket:10s} {'total':18s} " + " ".join(f"{t:.6f}" for t in bucket_totals))
        print(f"  {'all 64':29s} " + " ".join(f"{t:.6f}" for t in totals))
        print("  mean S-CIELAB dE by bucket " + "; ".join(
            f"{b['bucket']} {b['mean_de']:.5f}" for b in splits[-1]["buckets"]))
        prof = device_profile(lambda: batch(images, dev, lambda bucket, name, fn: fn()), args.trace)
        quality = {"stage_seconds": splits, "total_seconds": totals}
    else:
        img = natural_image(H, W, seed=0)
        splits = stage_split(img, dev, RUNS)
        names = list(splits[0]["seconds"])
        print(f"stage seconds, {W}x{H} K={K} pop={POP}, {RUNS} runs (first cold):")
        for name in names:
            print(f"  {name:36s} " + " ".join(f"{s['seconds'][name]:.6f}" for s in splits))
        totals = [sum(v for k, v in s["seconds"].items() if not k.startswith("(aside)")) for s in splits]
        print(f"  {'total (without the aside)':36s} " + " ".join(f"{t:.6f}" for t in totals))
        print("  mean S-CIELAB dE " + " ".join(f"{s['mean_de']:.5f}" for s in splits))
        prof = device_profile(lambda: schedule(img, dev, lambda name, fn: fn()), args.trace)
        quality = {"stage_seconds": splits, "total_seconds": totals}
    print(f"profile of one warm run: {prof['device_events']} device events, busy "
          f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, idle share "
          f"{prof['idle_share']:.4f}")
    for k in prof["by_kernel"][:TOP]:
        print(f"  {k['ms']:10.3f} ms {k['launches']:6d}x  {k['name'][:100]}")
    prof["by_kernel"] = prof["by_kernel"][:TOP]
    print(json.dumps({"device": smi, **quality, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
