"""The port's tools: the assignment probes, the multi-device tools, and the
quality-parity tools (`parity_check`, `fitness_parity`, `engine_run`, each
documented in its module) with `entry`, the flagship's forward step.

The probes are counterparts of the JAX package's TPU probes, named like
them and taking the same variants and argv, with the "block" argument read
as threads per CUDA block:

    python -m hybridquantization_tpu_torch.tools.vpu_assign_exp [variants] [threads]
    python -m hybridquantization_tpu_torch.tools.kexp_assign [variants] [threads] [precision]
    python -m hybridquantization_tpu_torch.tools.minidot_probe [dense mini128 ...]

Each draws its inputs as its counterpart's `main` does (numpy, seed 0) at the
true 3840x2160 frame (no padding to a TPU block), times 24 launches rotating
over 8 palette sets after a warm-up pass, with CUDA events, and prints the
card's name and power limit first, then ms per call and Mpix/s. Each `main`
runs on "cuda" unless the caller passes device="cpu" (where the plain
versions run and the host clock times them) and returns, by label, its ms
per call and the kernel launches it made (`launch_counts`).
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..ops import assign_kernel as ak
from ..ops import probe_kernels as pk

H, W, K, POP = 2160, 3840, 256, 4
SETS, REPS = 8, 24


def smi_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the CPU."""
    if device.type != "cuda":
        return f"device: {device} (plain versions, host clock)"
    return f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: {smi_line()}"


def ms_per_call(fn, sets, device: torch.device) -> float:
    """Mean ms of fn(sets[i % SETS]) over REPS calls, after one warm-up pass
    over the sets: CUDA events on the card, the host clock on the CPU."""
    for s in sets:
        fn(s)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(REPS):
            fn(sets[i % len(sets)])
        return (time.perf_counter() - t0) / REPS * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(REPS):
        fn(sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def pack_pixels(feats: torch.Tensor) -> torch.Tensor:
    """(P, 3) features -> (4, P) rows f0, f1, f2, 1 (JAX's pack_pixels, unpadded)."""
    return torch.cat([feats.T, torch.ones_like(feats[:, :1]).T]).contiguous()


def launch_counts(since: dict | None = None) -> dict:
    """The launch counters of the kernels the probes reach (less `since`)."""
    now = {"probe_kloop": pk.kloop_assign.launches, "split_rowmax": pk.split_rowmax.launches,
           "split_assign": pk.split_assign.launches, "assign_pop": ak.assign_opp_usage_pop.launches}
    return {k: v - (since or {}).get(k, 0) for k, v in now.items()}
