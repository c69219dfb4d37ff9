"""Quality parity: the port's engine against the f64 NumPy oracle.

The counterpart of `tools/parity_check.py`, with the same flags and output
lines. The BASELINE north star is mean S-CIELAB Delta-E and MSE within 1%
of the reference at the same K on identical inputs; the reference is
judged through `tests/oracle.py`, an independent NumPy implementation of
its pipeline. The anneal is stochastic, so parity is statistical: both
sides run S seeds and the mean final Delta-E and MSE are compared (24
seeds at imax 1500 is the trustworthy configuration: per-seed std is ~0.3
on both sides).

One judge for both sides: the oracle is not copied. It is loaded the way
the JAX tools load it, the repository root on `sys.path`, then
`from tests import oracle` (numpy and scipy only). This module also holds
what the port's parity tools share: the content images, bit-equal to the
JAX tools' (`tools/parity_check.py:37-53`, over the port's pinned `synth`
copy), and the final-quality judge `quality`.

The oracle seeds run in `--oracle-jobs` worker processes started with
"spawn" (never fork once CUDA is up) before the engine seeds, so their
NumPy overlaps the card's work. The engine runs on "cuda" (B1 and B2 every
fitness evaluation), or on the CPU with --cpu (the kernels' plain versions).

Usage:
  python -m hybridquantization_tpu_torch.tools.parity_check [--image PATH]
      [--size 96] [--colors 8] [--imax 1500] [--seeds 24] [--cpu]
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import queue as queue_mod
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
#: the judge's S-CIELAB viewing conditions (the oracle banks' and BASELINE's)
JUDGE_DPI, JUDGE_DIST_CM = 72, 45.0


def load_oracle():
    """The f64 judge `tests/oracle.py`, imported as the JAX tools import it."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tests import oracle

    return oracle


def make_test_image(size: int, rng) -> np.ndarray:
    """The historical smooth parity workload (the committed JSONL evidence
    depends on it staying bit-identical)."""
    from .. import synth

    return synth.smooth_test_image(size, rng)


def content_image(content: str, size: int, seed: int = 0) -> np.ndarray:
    """The parity runners' content axis: "smooth" or "natural"."""
    from .. import synth

    if content == "smooth":
        return make_test_image(size, np.random.default_rng(seed))
    if content == "natural":
        return synth.natural_image(size, size, seed=seed)
    raise ValueError(f"unknown content class {content!r}")


@functools.lru_cache(maxsize=1)
def judge_filters():
    """(ofilters, abs_k3) of the oracle's S-CIELAB filter bank."""
    ofilters, abs_k3, _ = load_oracle().build_filters(JUDGE_DPI, JUDGE_DIST_CM)
    return ofilters, abs_k3


def judge_target(img: np.ndarray) -> np.ndarray:
    """The f64 S-CIELAB image of the original, the judge's target."""
    return load_oracle().srgb_to_scielab(img.astype(np.float64), *judge_filters())


def quality(img: np.ndarray, palette, target64: np.ndarray, space: str = "srgb"):
    """(mean S-CIELAB Delta-E76, sRGB MSE) of `img` quantized to `palette`,
    the pixels re-assigned on the host in f64 by the oracle's first-minimum
    scan: in sRGB, or in CIELAB for space "lab" (the lab mode's final
    quantize; judging the engine's own f32 quantize would mix final-pass
    precisions across the two modes). `tools/engine_run.py:113-136`."""
    oracle = load_oracle()
    palette = np.asarray(palette, np.float64)
    pixels = img.reshape(-1, 3).astype(np.float64)
    if space == "lab":
        idx = oracle.nearest_palette(
            oracle.xyz_to_lab(oracle.srgb_to_xyz(pixels)),
            oracle.xyz_to_lab(oracle.srgb_to_xyz(palette)),
        )
    elif space == "srgb":
        idx = oracle.nearest_palette(pixels, palette)
    else:
        raise ValueError(f"unknown assignment space {space!r}")
    q = palette[idx].reshape(img.shape)
    q_lab = oracle.srgb_to_scielab(q, *judge_filters())
    return float(oracle.delta_e76(target64, q_lab).mean()), float(((q - img) ** 2).mean())


def _oracle_worker(out, seeds, img, colors, population, imax, dtype) -> None:
    """Run and judge the oracle's own SWASA search for each seed, putting
    (seed, deltaE, mse, seconds) on `out` as each ends. Module-level, so a
    spawned process can unpickle it."""
    oracle = load_oracle()
    target = judge_target(img)
    for s in seeds:
        t0 = time.time()

        def progress(ite, s=s, t0=t0):
            print(f"[oracle] seed {s}: iter {ite}/{imax} ({time.time() - t0:.0f}s)", flush=True)

        pal, _ = oracle.swasa_search(
            img.astype(dtype), colors, seed=s, population=population, imax=imax, dtype=dtype,
            progress=progress,
        )
        out.put((s, *quality(img, pal, target), time.time() - t0))


def _collect(q, procs, chunks, n_seeds):
    """The oracle workers' results as they come. A worker that dies writes
    off only its undelivered seeds; the others are still collected."""
    results = []
    undelivered = {i: set(c) for i, c in enumerate(chunks)}
    written_off = set()
    pending = n_seeds
    while pending:
        try:
            s, de, mse, dt = q.get(timeout=30.0)
        except queue_mod.Empty:
            for i, p in enumerate(procs):
                if i not in written_off and not p.is_alive() and p.exitcode not in (0, None):
                    written_off.add(i)
                    lost = len(undelivered[i])
                    pending -= lost
                    print(
                        f"ERROR: oracle worker {i} died (exitcode {p.exitcode}), abandoning "
                        f"its {lost} undelivered seed(s) {sorted(undelivered[i])}; "
                        "continuing with live workers", file=sys.stderr,
                    )
            if pending and all(not p.is_alive() for p in procs) and q.empty():
                print(f"ERROR: all oracle workers exited with only {len(results)}/{n_seeds} "
                      "seeds delivered", file=sys.stderr)
                break
            continue
        pending -= 1
        for dset in undelivered.values():
            dset.discard(s)
        results.append((de, mse))
        print(f"[oracle] seed {s}: deltaE {de:.4f}  mse {mse:.6f}  ({dt:.1f}s)", flush=True)
    return results


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", help="input image (default: synthetic)")
    ap.add_argument("--content", default="smooth", choices=["smooth", "natural"],
                    help="synthetic content class: 'smooth' (historical parity workload) or "
                    "'natural' (1/f multi-octave value noise, synth.natural_image)")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--colors", "-k", type=int, default=8)
    ap.add_argument("--imax", type=int, default=1500)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--tolerance", type=float, default=0.01, help="relative gap for PASS")
    ap.add_argument("--oracle-jobs", type=int, default=1,
                    help="oracle worker processes, spawned before the engine seeds")
    ap.add_argument("--oracle-dtype", default="f64", choices=["f64", "f32"],
                    help="oracle SEARCH precision (the judge is always f64); f32 matches the "
                    "reference's OpenCL path and runs ~2x faster")
    ap.add_argument("--precision", default="f32x3", choices=["highest", "f32x3", "bf16"])
    ap.add_argument("--tie-mode", default="first", choices=["first", "average"])
    ap.add_argument("--conv-precision", default="", choices=["", "highest", "f32x3", "bf16"],
                    help="S-CIELAB filter precision, separable from assignment scores")
    ap.add_argument("--fast", action="store_true",
                    help="validate the fast mode: --precision bf16 --tie-mode average")
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    return ap.parse_args(argv)


def main(argv=None, *, device="cuda") -> int:
    args = parse_args(argv)
    if args.cpu:
        device = "cpu"
    if args.fast:
        args.precision, args.tie_mode = "bf16", "average"
    if args.seeds < 24:
        print(f"WARNING: --seeds {args.seeds} < 24. Per-seed final-error std is ~0.3 on both "
              "sides; a few-seed mean aliases into the 1% tolerance and the PASS/FAIL verdict "
              "is NOISE. Use >= 24 seeds for a trustworthy comparison.", file=sys.stderr)
    if args.imax < 1500:
        print(f"WARNING: --imax {args.imax} < 1500: the anneal has not converged and the "
              "quality comparison is not meaningful (gap ~6% at imax=300).", file=sys.stderr)

    import torch

    from .. import HybridQuantizer, QuantizationConfig, SWASAConfig
    from .. import io as hio
    from ..pipeline import setup_device
    from . import device_line

    dev = setup_device(device)
    img = hio.load_image(args.image) if args.image else content_image(args.content, args.size)
    print(device_line(dev))
    print(f"engine precision={args.precision} tie_mode={args.tie_mode} "
          f"conv_precision={args.conv_precision or args.precision} "
          f"oracle_dtype={args.oracle_dtype} content={args.content}")
    target = judge_target(img)

    odtype = np.float32 if args.oracle_dtype == "f32" else np.float64
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    seeds = list(range(args.seeds))
    chunks = [c for j in range(max(args.oracle_jobs, 1)) if (c := seeds[j :: args.oracle_jobs])]
    procs = [
        mp.Process(target=_oracle_worker, daemon=True,
                   args=(q, c, img, args.colors, args.population, args.imax, odtype))
        for c in chunks
    ]
    for p in procs:
        p.start()
    try:
        cfg = QuantizationConfig(
            swasa=SWASAConfig(num_colors=args.colors, population=args.population, imax=args.imax),
            precision=args.precision, tie_mode=args.tie_mode, conv_precision=args.conv_precision,
        )
        engine = HybridQuantizer(cfg, device=dev)
        ours = []
        for s in seeds:
            t0 = time.time()
            pal, _ = engine.find_palette(
                img, generator=torch.Generator(device=dev).manual_seed(s), chunk_size=args.imax
            )
            de, mse = quality(img, pal.cpu().numpy(), target)
            ours.append((de, mse))
            print(f"[ours]   seed {s}: deltaE {de:.4f}  mse {mse:.6f}  ({time.time() - t0:.1f}s)",
                  flush=True)
        theirs = _collect(q, procs, chunks, args.seeds)
    finally:
        for p in procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()
                p.join()
    if not theirs:
        print("no oracle seeds collected — cannot compare", file=sys.stderr)
        return 2

    ours_de, ours_mse = np.mean(ours, axis=0)
    oracle_de, oracle_mse = np.mean(theirs, axis=0)
    gap_de = abs(ours_de - oracle_de) / oracle_de
    gap_mse = abs(ours_mse - oracle_mse) / max(oracle_mse, 1e-12)
    print(f"\nmean deltaE: ours {ours_de:.4f} vs oracle {oracle_de:.4f} (gap {gap_de * 100:.2f}%)")
    print(f"mean MSE:    ours {ours_mse:.6f} vs oracle {oracle_mse:.6f} "
          f"(gap {gap_mse * 100:.2f}%)")
    ok = gap_de <= args.tolerance
    print("PARITY:", "PASS" if ok else "FAIL", f"(deltaE tolerance {args.tolerance:.0%})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
