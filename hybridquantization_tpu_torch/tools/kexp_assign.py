"""The assignment scheduling probe (T4) on the port's kernels.

Counterpart of the JAX package's `tools/kexp_assign.py`, whose variants are
schedules of B1's function at the f32x3 split-bf16 precision on the TPU
(dot, first-index chain and gathers reordered) or the bisect's stand-ins
for part of its work. Here the schedules are one kernel, `split_assign`,
and the stand-ins are torch ops on its outputs:

  current interleave pairskew counts16 nowhen foldusage
                 split_assign (exact 3-part colour), counts per entry
  avg            split_assign, tie_mode="average" (summed colour, hits)
  rowmax         usage flags counts > 0
  nocounts       zero usage
  nogather       colour rows (idx == 0, idx == 1, idx == 2), zero usage
  dotmax         split_rowmax broadcast to 3 rows, zero usage

At precision "highest" or "bf16", `current` launches B1
(ops.assign_kernel.assign_opp_usage_pop); the other variants exist only at
f32x3.

    python -m hybridquantization_tpu_torch.tools.kexp_assign [variants] [threads] [precision]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import assign_kernel as ak
from ..ops import probe_kernels as pk
from ..pipeline import setup_device
from . import H, K, POP, SETS, W, device_line, launch_counts, ms_per_call, pack_pixels

SCHEDULES = ("current", "interleave", "pairskew", "counts16", "nowhen", "foldusage")
VARIANTS = SCHEDULES + ("avg", "rowmax", "nocounts", "nogather", "dotmax")


def variant_outputs(v: str, opp, counts, idx, rowmax=None):
    """Variant `v`'s (opp (pop, 3, P), usage (pop, K)) from the outputs of
    split_assign (opp, counts, idx) or, for `dotmax`, split_rowmax."""
    if v == "dotmax":
        return rowmax[:, None, :].expand(-1, 3, -1), torch.zeros_like(counts)
    if v == "rowmax":
        return opp, counts > 0
    if v == "nocounts":
        return opp, torch.zeros_like(counts)
    if v == "nogather":
        return torch.stack([(idx == r) for r in range(3)], dim=1).to(torch.float32), torch.zeros_like(counts)
    return opp, counts


def run_variant(v: str, x4, c4, o4, threads: int = pk.DEFAULT_THREADS):
    """(opp (pop, 3, P), usage (pop, K)) of variant `v` at f32x3."""
    if v not in VARIANTS:
        raise ValueError(f"unknown variant {v!r}; options: {list(VARIANTS)}")
    if v == "dotmax":
        zeros = torch.zeros((c4.shape[0], c4.shape[-1]), dtype=torch.int32, device=x4.device)
        return variant_outputs(v, None, zeros, None, pk.split_rowmax(x4, c4, threads=threads))
    tie_mode = "average" if v == "avg" else "first"
    out = pk.split_assign(x4, c4, o4, tie_mode=tie_mode, return_index=True, threads=threads)
    return variant_outputs(v, *out)


def main(argv=None, *, device="cuda", shape=(H, W)) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = setup_device(device)
    print(device_line(dev), flush=True)
    P = shape[0] * shape[1]
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.random((P, 3), dtype=np.float32), device=dev)
    pals = torch.as_tensor(rng.random((SETS, POP, K, 3)).astype(np.float32), device=dev)
    print(f"{shape[1]}x{shape[0]} = {P / 1e6:.2f} Mpix, K={K}, pop={POP}")
    variants = argv[0].split(",") if argv else ["current", "dotmax", "interleave", "pairskew"]
    blocks = [int(b) for b in (argv[1].split(",") if len(argv) > 1 else ["256"])]
    precision = argv[2] if len(argv) > 2 else "f32x3"
    if precision != "f32x3" and variants != ["current"]:
        raise ValueError(f"at precision {precision!r} only `current` runs (B1)")
    x4 = pack_pixels(feats)
    c4s, o4s = pk.pack_palette(pals, pals)
    out = {}
    for threads in blocks:
        for v in variants:
            if precision == "f32x3":
                sets = list(zip(c4s, o4s))
                fn = lambda s, v=v: run_variant(v, x4, s[0], s[1], threads)  # noqa: E731
            else:
                sets = list(pals)
                fn = lambda s: ak.assign_opp_usage_pop(feats, s, s, precision=precision)  # noqa: E731
            before = launch_counts()
            ms = ms_per_call(fn, sets, dev)
            out[(threads, v)] = {"ms": ms, "launches": launch_counts(before)}
            print(f"threads {threads:5d} {v:11s} {ms:8.3f} ms/call  {POP * P / ms / 1e3:7.0f} Mpix/s",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
