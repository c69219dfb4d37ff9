"""The pruning probe (T5–T8) on the port's kernels: per-run candidate
palettes against one dense palette.

Counterpart of the JAX package's `tools/minidot_probe.py`. x is random in
all 4 rows and so are the candidates (row 3 is neither ones nor a bias);
the score is the split-bf16 one. Variants:

  dense                   max over K=256 per pixel (T5, split_rowmax)
  mini128, mini256        max over the KC=64 candidates of each 128- or
                          256-pixel run (T6, split_rowmax with run)
  minifull128, minifull256, minifull2_128, minifull2_256
                          each run's first-index winner, its colour from 2
                          bf16 parts, counts per candidate slot (T7, T8:
                          one function, split_assign with run)

The candidate sets are drawn as the JAX probe draws them, one per run of
an 8192-pixel block (64 of 128 pixels, 32 of 256), and every block reuses
them, as the JAX probe's BlockSpecs do.

    python -m hybridquantization_tpu_torch.tools.minidot_probe [variants ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_kernels as pk
from ..pipeline import setup_device
from . import H, K, POP, SETS, W, device_line, launch_counts, ms_per_call

BLOCK = 8192  # the JAX probe's pixel block: the period of its candidate sets
KC = 64  # candidates per run
RUN = {"mini128": 128, "mini256": 256, "minifull128": 128, "minifull256": 256,
       "minifull2_128": 128, "minifull2_256": 256}


def per_run(sets: torch.Tensor, P: int, run: int) -> torch.Tensor:
    """(SETS, POP, BLOCK // run, 4, KC) sets of one block -> (SETS, POP,
    ceil(P / run), 4, KC), run r taking set r % (BLOCK // run)."""
    r = torch.arange(-(-P // run), device=sets.device) % sets.shape[2]
    return sets[:, :, r].contiguous()


def main(argv=None, *, device="cuda", shape=(H, W)) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = setup_device(device)
    print(device_line(dev), flush=True)
    P = shape[0] * shape[1]
    rng = np.random.default_rng(0)
    x4 = torch.as_tensor(rng.random((4, P), dtype=np.float32), device=dev)
    cd = torch.as_tensor(rng.random((SETS, POP, 4, K), dtype=np.float32), device=dev)
    n_runs = BLOCK // 128
    cm = {128: torch.as_tensor(rng.random((SETS, POP, n_runs, 4, KC), dtype=np.float32), device=dev),
          256: torch.as_tensor(rng.random((SETS, POP, n_runs // 2, 4, KC), dtype=np.float32),
                               device=dev)}
    print(f"{shape[1]}x{shape[0]} = {P / 1e6:.2f} Mpix, K={K}, KC={KC}, pop={POP}")
    which = argv or ["dense", "mini128", "mini256"]
    out = {}
    for v in which:
        if v == "dense":
            name, sets = f"dense K={K} dot+max", list(cd)
            fn = lambda c: pk.split_rowmax(x4, c)  # noqa: E731
        elif v in RUN:
            run = RUN[v]
            sets = list(per_run(cm[run], P, run))
            if v.startswith("mini1") or v.startswith("mini2"):
                name = f"mini {P // run}x(K'={KC}) {run}-px runs"
                fn = lambda c, run=run: pk.split_rowmax(x4, c, run=run)  # noqa: E731
            else:
                kind = "FULL2" if v.startswith("minifull2_") else "FULL"
                name = f"mini-{kind} {P // run}x(K'={KC}) {run}-px runs"
                fn = lambda c, run=run: pk.split_assign(x4, c, c, run=run, opp_parts=2)  # noqa: E731
        else:
            raise ValueError(f"unknown variant {v!r}")
        before = launch_counts()
        ms = ms_per_call(fn, sets, dev)
        del sets
        out[v] = {"ms": ms, "launches": launch_counts(before)}
        print(f"{name}: {ms:8.3f} ms  {POP * P / ms / 1e3:7.0f} Mpix/s", flush=True)
    return out


if __name__ == "__main__":
    main()
