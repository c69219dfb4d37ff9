#!/usr/bin/env python3
"""The multi-device engine over NCCL, one rank per card.

    python3 chip_mesh.py            # on a machine with two cards or more

Run from the root of a checkout. It builds the kernels, then on the 4K
natural frame at K=256, pop 4:

  1. the quality schedule (k-means, imax=50, polish 10, quantize,
     error_images) through ShardedBatchQuantizer, columns, on (1, 1, n) for
     n = 2 and 4 (as far as the cards go), each against BatchQuantizer on
     one card: ranks bit-equal, fitness of fixed palettes, final mean dE,
     launches per rank (chip_smoke's phase (d));
  2. `tools.dryrun_multichip` on as many ranks as cards (at most 4);
  3. `tools.bench_multichip.measure_scaling` at 1, 2, 4 shards;
  4. seconds per iteration of the column fitness, member-pipelined and
     batched, on (1, 1, n), and a torch.profiler table of rank 0's
     pipelined iterations on (1, 1, 2).

It prints the card's name and power limit first and last. Imports torch,
numpy, the standard library, chip_smoke and the port; never jax.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

PROFILE_ITERS, TIMED_ITERS = 5, 20


def _pipelined_vs_batched(rank, n) -> dict:
    """ms per iteration of the column fitness on (1, 1, n), member-pipelined
    and batched, after a warm chunk; rank 0 of n = 2 also prints a profile."""
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.parallel import ShardedBatchQuantizer, make_mesh
    from hybridquantization_tpu_torch.swasa import loop as swasa_loop

    mesh = make_mesh(1, n, 1, "cuda")
    images = torch.as_tensor(np.random.default_rng(0).random((1, cs.H, cs.W, 3), dtype=np.float32),
                             device=mesh.device)
    out = {}
    for overlap in (True, False):
        cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=cs.K, population=cs.POP, imax=10**6),
                                 overlap_collectives=overlap)
        q = ShardedBatchQuantizer(cfg, mesh, strategy="columns")
        fitness = q._columns[0](images)
        state = swasa_loop.init_state((torch.Generator(device=q.device).manual_seed(0),), fitness, cfg.swasa)
        state, _ = swasa_loop.run_chunk(state, fitness, cfg.swasa, 10)
        t0 = time.perf_counter()
        state, _ = swasa_loop.run_chunk(state, fitness, cfg.swasa, TIMED_ITERS)
        out["pipelined" if overlap else "batched"] = (time.perf_counter() - t0) / TIMED_ITERS * 1e3
        if overlap and n == 2:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if rank == 0 else None
            with prof or contextlib.nullcontext():
                state, _ = swasa_loop.run_chunk(state, fitness, cfg.swasa, PROFILE_ITERS)
                torch.cuda.synchronize()
            if prof is not None:
                print(f"profile, rank 0 of (1, 1, 2), {PROFILE_ITERS} member-pipelined iterations:", flush=True)
                print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12), flush=True)
                print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=8), flush=True)
    return out


def main() -> int:
    name, smi = cs.phase_device()
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_mesh: {cards} card; NCCL needs one card per rank", file=sys.stderr)
        return 1
    cs.phase_build()
    from hybridquantization_tpu_torch.parallel.multihost import launch
    from hybridquantization_tpu_torch.pipeline import setup_device
    from hybridquantization_tpu_torch.synth import natural_image
    from hybridquantization_tpu_torch.tools.bench_multichip import measure_scaling
    from hybridquantization_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    dev = setup_device("cuda")
    img = natural_image(cs.H, cs.W, seed=0)
    shards = [n for n in (2, 4) if n <= cards]
    with tempfile.TemporaryDirectory() as tmp:
        frame = os.path.join(tmp, "frame.npy")
        np.save(frame, img)
        for n in shards:
            t0 = time.perf_counter()
            ranks = launch(cs._mesh_engine_rank, n, (frame, (1, 1, n), "cuda"), device="cuda", backend="nccl")
            cs._engine_against_one_device(ranks, img, dev, f"mesh NCCL columns 1x1x{n}, one rank per card")
            print(f"launch of {n} NCCL ranks, set-up included: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dryrun_multichip(min(cards, 4))
    print(f"dryrun_multichip({min(cards, 4)}) over NCCL: {time.perf_counter() - t0:.1f} s", flush=True)
    measure_scaling([1, *shards], cs.H, cs.W, cs.K, cs.POP, iters=10, reps=3,
                    log=lambda line: print(f"scaling {line}", flush=True))
    for n in shards:
        times = launch(_pipelined_vs_batched, n, (n,), device="cuda", backend="nccl")
        print(f"column fitness 1x1x{n} {cs.W}x{cs.H} K={cs.K} pop={cs.POP}, ms/iter per rank: member-pipelined "
              f"{[t['pipelined'] for t in times]}, batched {[t['batched'] for t in times]}",
              flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
