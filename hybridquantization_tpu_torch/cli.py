"""Command-line interface — the reference's GUI parameter panel as a CLI.

The counterpart of `hybridquantization_tpu/cli.py`, with the same flags,
defaults and messages. Every flag mirrors an EzPlug GUI variable with the
same default, range, and tooltip meaning (HybridQuantization.initialize,
HybridQuantization.java:185-257). Two modes, like the plugin's
EzQuantization toggle (:63-85), and the batch command:

  quantize        — find the best K-color palette and write the quantized image
  error           — Delta-E error image between two images (:139-155)
  quantize-batch  — many images, bucketed by resolution, each bucket one
                    batched anneal on the GPU (parallel.BatchQuantizer), or
                    over a mesh of ranks (parallel.ShardedBatchQuantizer):
                    --mesh-* above 1 starts one process per rank on this
                    host; --distributed joins a job started on several

The engine runs on the CUDA device and raises when there is none; `main`'s
`device` keyword is for callers that run it elsewhere (the CPU tests).
Ranks talk over NCCL on "cuda" (one card each) and gloo on "cpu".
`.ppm` files need no PIL.

Example:
  python -m hybridquantization_tpu_torch.cli quantize in.ppm out.ppm --colors 8
  python -m hybridquantization_tpu_torch.cli error orig.ppm quant.ppm --out err.ppm
  python -m hybridquantization_tpu_torch.cli quantize-batch a.ppm b.ppm --out-dir out --fast
  python -m hybridquantization_tpu_torch.cli quantize-batch a.ppm b.ppm --out-dir out --mesh-pixel 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import io as hio
from .checkpoint import load_state, save_state
from .config import QuantizationConfig, ScielabConfig, SWASAConfig
from .pipeline import HybridQuantizer


def _add_common(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("S-CIELAB")
    g.add_argument("--dpi", type=int, default=72, help="screen dpi (default 72)")
    g.add_argument(
        "--viewing-distance", type=float, default=45.0,
        help="viewing distance in cm (default 45)",
    )
    g.add_argument(
        "--whitepoint", choices=["D65", "D50"], default="D65",
        help="whitepoint (default D65)",
    )
    p.add_argument(
        "--delta-e", choices=["CIE76", "CIE94", "CIEDE2000"], default="CIE76",
        help="Delta-E formula (reference plugin hardcodes CIE76)",
    )
    p.add_argument("--verbose", action="store_true", help="verbose stdout")
    p.add_argument(
        "--profile", metavar="LOGDIR",
        help="record a torch.profiler trace of the run into LOGDIR/trace.json",
    )
    g = p.add_argument_group("precision")
    g.add_argument(
        "--precision", choices=["highest", "f32x3", "bf16"], default="f32x3",
        help="assignment-score and S-CIELAB filter precision (highest and "
        "f32x3 both run fp32 here; bf16 rounds the operands to bf16 as the "
        "TPU's single-pass matmul does)",
    )
    g.add_argument(
        "--tie-mode", choices=["first", "average"], default="first",
        help="exact-score tie handling in the assignment kernel (default "
        "'first' = reference semantics; 'average' = the mean colour of the "
        "tied entries, each marked used)",
    )
    g.add_argument(
        "--conv-precision", choices=["", "highest", "f32x3", "bf16"],
        default="",
        help="S-CIELAB filter precision, separable from the assignment "
        "--precision (default '': same)",
    )
    g.add_argument(
        "--fast", action="store_true",
        help="shorthand for --precision bf16 --tie-mode average (on the TPU "
        "it trades mean-deltaE for speed, the cost growing with config scale "
        "— ~1.2%% at 64^2/K6 but ~5.5%% at 512^2/K16, docs/PERFORMANCE.md; "
        "on the GPU it is no faster, PERF.md)",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hybridquantization_tpu_torch",
        description="hybrid perceptual color quantization on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    q = sub.add_parser("quantize", help="quantize an image to K colors")
    q.add_argument("input", help="input image")
    q.add_argument("output", help="output image path")
    q.add_argument("--colors", "-k", type=int, default=8, help="palette size (default 8)")
    g = q.add_argument_group("optimization")
    g.add_argument("--population", type=int, default=4, help="candidate palettes (default 4)")
    g.add_argument("--imax", type=int, default=5000, help="max iterations (default 5000)")
    g.add_argument("--delta", type=float, default=2.0, help="unused-color penalty (default 2)")
    g.add_argument("--no-convergence", action="store_true", help="disable population convergence")
    g.add_argument("--conv-delay", type=float, default=0.75)
    g.add_argument("--conv-spread", type=float, default=0.15)
    g = q.add_argument_group("temperature")
    g.add_argument("--t0", type=float, default=20.0, help="initial temperature (default 20)")
    g.add_argument("--itc", type=int, default=20, help="iterations per temperature step (default 20)")
    g.add_argument("--alpha", type=float, default=0.9, help="cooling coefficient (default 0.9)")
    g = q.add_argument_group("step size")
    g.add_argument("--s0", type=float, default=100.0, help="initial max step width (default 100)")
    g.add_argument("--beta", type=float, default=5.3, help="step adaptation constant (default 5.3)")
    q.add_argument(
        "--assignment-space", choices=["srgb", "lab"], default="srgb",
        help="palette assignment distance space (srgb = reference parity)",
    )
    q.add_argument("--seed", type=int, default=0, help="PRNG seed (reference was unseeded)")
    q.add_argument(
        "--init", choices=["random", "kmeans"], default="random",
        help="initial palettes: 'random' = reference parity; 'kmeans' = "
        "histogram-weighted k-means seeds (usually converges in far fewer "
        "iterations)",
    )
    q.add_argument(
        "--polish", type=int, default=0, metavar="N",
        help="Lloyd (k-means) refinement steps after the anneal (beyond-"
        "reference feature; monotone in assignment-space MSE)",
    )
    q.add_argument(
        "--dither", type=float, default=0.0, metavar="S",
        help="ordered Bayer dithering strength for the final quantize pass "
        "(0 = off, reference parity; ~1 reduces gradient banding)",
    )
    q.add_argument("--error-image", metavar="PATH", help="also write the Delta-E error image")
    q.add_argument("--palette-out", metavar="PATH", help="write the palette as .npy")
    q.add_argument("--checkpoint", metavar="PATH", help="checkpoint file to save/resume")
    q.add_argument("--checkpoint-every", type=int, default=500, help="iterations between checkpoints")
    _add_common(q)

    e = sub.add_parser("error", help="Delta-E error image between two images")
    e.add_argument("original")
    e.add_argument("quantized")
    e.add_argument("--out", required=True, help="error image output path")
    _add_common(e)

    b = sub.add_parser(
        "quantize-batch",
        help="quantize many images in batches on one GPU or a mesh of them (mixed resolutions ok)",
    )
    b.add_argument("inputs", nargs="+", help="input images")
    b.add_argument("--out-dir", required=True, help="output directory")
    b.add_argument("--colors", "-k", type=int, default=256)
    b.add_argument("--imax", type=int, default=500)
    b.add_argument("--population", type=int, default=4)
    b.add_argument("--mesh-data", type=int, default=1, help="data-parallel mesh axis")
    b.add_argument(
        "--mesh-pixel", type=int, default=0,
        help="pixel mesh axis (0 = the rest of the ranks: 1 without --distributed)",
    )
    b.add_argument(
        "--mesh-pop", type=int, default=1,
        help="population (EP) mesh axis: shard the SWASA candidates over "
        "this many ranks (must divide --population; ignored with "
        "--distributed)",
    )
    b.add_argument(
        "--assignment-space", choices=["srgb", "lab"], default="srgb"
    )
    b.add_argument("--seed", type=int, default=0)
    b.add_argument(
        "--init", choices=["random", "kmeans"], default="random",
        help="initial palettes (see quantize --init)",
    )
    b.add_argument(
        "--polish", type=int, default=0, metavar="N",
        help="Lloyd refinement steps after each anneal (see quantize --polish)",
    )
    b.add_argument(
        "--error-images", metavar="DIR",
        help="also write per-image Delta-E error images (reference error-"
        "image mode) into DIR as <name>_DE.png",
    )
    g = b.add_argument_group("multi-host (one process per rank; parallel.multihost)")
    g.add_argument(
        "--distributed", action="store_true",
        help="join the job's process group before building the mesh",
    )
    g.add_argument("--coordinator", default=None, help="coordinator host:port (or a file:// URL)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    _add_common(b)
    return parser


def _config_from_args(args) -> QuantizationConfig:
    swasa = SWASAConfig(
        num_colors=getattr(args, "colors", 8),
        population=getattr(args, "population", 4),
        imax=getattr(args, "imax", 5000),
        delta=getattr(args, "delta", 2.0),
        convergence=not getattr(args, "no_convergence", False),
        conv_delay=getattr(args, "conv_delay", 0.75),
        conv_spread=getattr(args, "conv_spread", 0.15),
        t0=getattr(args, "t0", 20.0),
        i_tc=getattr(args, "itc", 20),
        alpha=getattr(args, "alpha", 0.9),
        s0=getattr(args, "s0", 100.0),
        beta=getattr(args, "beta", 5.3),
    )
    return QuantizationConfig(
        swasa=swasa,
        scielab=ScielabConfig(
            dpi=args.dpi,
            viewing_distance_cm=args.viewing_distance,
            whitepoint=args.whitepoint,
        ),
        deltaE=args.delta_e,
        assignment_space=getattr(args, "assignment_space", "srgb"),
        precision="bf16" if args.fast else args.precision,
        tie_mode="average" if args.fast else args.tie_mode,
        conv_precision=getattr(args, "conv_precision", ""),
        init=getattr(args, "init", "random"),
        verbose=args.verbose,
        seed=getattr(args, "seed", 0),
    )


def cmd_quantize(args, device="cuda") -> int:
    cfg = _config_from_args(args)
    engine = HybridQuantizer(cfg, device=device)
    image = hio.load_image(args.input)
    print(f"image {image.shape[1]}x{image.shape[0]}, K={cfg.swasa.num_colors}")

    initial_state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        initial_state, _ = load_state(args.checkpoint, engine.device)
        print(
            f"resuming from {args.checkpoint} at iteration "
            f"{int(initial_state.iteration)}"
        )

    start = time.time()

    def progress(done, imax, t):
        eta = t.get("eta_s", 0.0)
        mins, secs = divmod(int(eta), 60)
        sys.stdout.write(
            f"\r{done}/{imax} : {mins}m{secs}s remaining  best {t['best_error']:.5f}  "
        )
        sys.stdout.flush()
        return True

    palette, info = engine.find_palette(
        image,
        progress=progress,
        initial_state=initial_state,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
    )
    print(f"\noptimization: {time.time() - start:.1f}s, final error {info['best_error']:.5f}")

    if args.checkpoint:
        save_state(args.checkpoint, info["state"], {"best_error": info["best_error"]})
    if args.polish:
        palette = engine.polish(image, palette, iters=args.polish)
        print(f"polished palette with {args.polish} Lloyd steps")
    out = engine.quantize(image, palette, dither=args.dither)
    hio.save_image(args.output, out.cpu().numpy())
    print(f"wrote {args.output}")
    if args.palette_out:
        np.save(args.palette_out, palette.cpu().numpy())
    if args.error_image:
        mean_de, viz = engine.error_image(image, out)
        hio.save_image(args.error_image, viz.cpu().numpy())
        print(f"DeltaE : {float(mean_de)}")
    return 0


def cmd_error(args, device="cuda") -> int:
    cfg = _config_from_args(args)
    engine = HybridQuantizer(cfg, device=device)
    orig = hio.load_image(args.original)
    quant = hio.load_image(args.quantized)
    if orig.shape != quant.shape:
        print("Mismatching image sizes, abort.", file=sys.stderr)
        return 2
    mean_de, viz = engine.error_image(orig, quant)
    hio.save_image(args.out, viz.cpu().numpy())
    print(f"DeltaE : {float(mean_de)}")
    return 0


def cmd_quantize_batch(args, device="cuda") -> int:
    """quantize-batch: one rank (BatchQuantizer), --mesh-* ranks started
    here (one process each, parallel.multihost.launch), or a --distributed
    job's rank."""
    from .parallel.multihost import distributed_mesh, init_distributed, launch

    if args.distributed:
        if args.mesh_data != 1:
            print(
                "--mesh-data is ignored with --distributed: the data axis is "
                "derived as total ranks / --mesh-pixel",
                file=sys.stderr,
            )
        init_distributed(args.coordinator, args.num_processes, args.process_id, device=device)
        return _quantize_batch(args, distributed_mesh(args.mesh_pixel or None, device))
    shape = (args.mesh_data, args.mesh_pixel or 1, args.mesh_pop)
    ranks = shape[0] * shape[1] * shape[2]
    if ranks == 1:
        return _quantize_batch(args, None, device)
    launch(_quantize_batch_rank, ranks, (args, shape, device), device=device)
    return 0


def _quantize_batch_rank(rank, args, shape, device) -> int:
    """One rank of a quantize-batch mesh started by `launch`."""
    from .parallel import make_mesh

    n_data, n_pixel, n_pop = shape
    return _quantize_batch(args, make_mesh(n_data, n_pixel, n_pop, device))


def _quantize_batch(args, mesh, device=None) -> int:
    """Run the batch on this rank: BatchQuantizer without a mesh, else
    ShardedBatchQuantizer. Only the mesh's rank 0 prints and writes files."""
    from . import native
    from .batching import run_bucketed
    from .parallel import BatchQuantizer, ShardedBatchQuantizer

    # _config_from_args reads the batch flags (colors/population/imax) and
    # carries precision/tie_mode/fast through.
    cfg = _config_from_args(args)
    if mesh is None:
        engine, lead = BatchQuantizer(cfg, device=device), True
        print(f"mesh 1x1, {len(args.inputs)} images, K={args.colors}")
    else:
        engine, lead = ShardedBatchQuantizer(cfg, mesh), mesh.rank == 0
        if lead:
            print(
                f"mesh {engine.n_data}x{engine.n_pixel}, {len(args.inputs)} images, K={args.colors} "
                f"({engine.n_data}x{engine.n_pop}x{engine.n_pixel} ranks, {mesh.backend} on {mesh.device.type})"
            )

    images = [native.load_image(p) for p in args.inputs]
    if lead:
        os.makedirs(args.out_dir, exist_ok=True)
        if args.error_images:
            os.makedirs(args.error_images, exist_ok=True)

    def run_batch(stack):
        out, info = engine.run(stack, polish_iters=args.polish)
        res = (out.cpu().numpy(), info["best_errors"], info["palettes"].cpu().numpy())
        if args.error_images:
            de, viz = engine.error_images(stack, out)
            return (*res, de.cpu().numpy(), viz.cpu().numpy())
        return res

    t0 = time.time()
    results = run_bucketed(images, run_batch, n_data=getattr(engine, "n_data", 1))
    dt = time.time() - t0
    if not lead:
        return 0
    total_pix = sum(im.shape[0] * im.shape[1] for im in images)
    for path, res in zip(args.inputs, results):
        out, err, palette = res[:3]
        name = os.path.splitext(os.path.basename(path))[0]
        dest = os.path.join(args.out_dir, f"{name}_q{args.colors}.png")
        hio.save_image(dest, out)
        line = f"{dest}  error={float(err):.4f}"
        if args.error_images:
            de, viz = res[3], res[4]
            epath = os.path.join(args.error_images, f"{name}_DE.png")
            hio.save_image(epath, viz)
            line += f"  DeltaE={float(de):.4f} -> {epath}"
        print(line)
    print(
        f"batch done: {dt:.1f}s, {total_pix / 1e6:.1f} Mpix, "
        f"{total_pix * args.imax * args.population / dt / 1e6:.0f} Mpix-evals/s"
    )
    return 0


def main(argv=None, device=None) -> int:
    """Run one command. `device` is the engine's device ("cuda" when None)."""
    args = build_parser().parse_args(argv)
    device = device or "cuda"
    from .metrics import profiler_trace

    with profiler_trace(getattr(args, "profile", None)):
        if args.command == "quantize":
            return cmd_quantize(args, device)
        if args.command == "quantize-batch":
            return cmd_quantize_batch(args, device)
        return cmd_error(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
