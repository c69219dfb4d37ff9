"""The k-loop and scores-dot probe (T1, T2, T3) on the port's kernels.

Counterpart of the JAX package's `tools/vpu_assign_exp.py`: B1's function
at 4K/K256/pop4 as a k-loop over the palette (T1 `vpu*`: one thread per
pixel; T2 `grp8*`: eight lanes per pixel, each scanning every eighth entry,
merged by shuffles), beside the split-bf16 scores dot and its row max (T3
`dotf32`, `dotbf16`) and the f32x3 assignment (`cur`).

    python -m hybridquantization_tpu_torch.tools.vpu_assign_exp [variants] [threads]

  variants  comma list of cur, vpu, vpu_u4, vpu_u16, vpu_fused, grp8,
            grp8s<sub>, grp8s<sub>u<unroll>, dotf32, dotbf16 (default cur,grp8);
            <sub> (the TPU's pixel sub-blocks) is accepted and has no effect
  threads   comma list of threads per CUDA block (default 256)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_kernels as pk
from ..pipeline import setup_device
from . import H, K, POP, SETS, W, device_line, launch_counts, ms_per_call, pack_pixels

VPU_UNROLL = {"vpu": 8, "vpu_u4": 4, "vpu_u16": 16, "vpu_fused": 8}


def variant_fn(v: str, x4: torch.Tensor, threads: int):
    """The call variant `v` makes on one (c4, o4) palette set."""
    if v == "cur":
        return lambda s: pk.split_assign(x4, s[0], s[1], threads=threads)
    if v in ("dotf32", "dotbf16"):
        return lambda s: pk.split_rowmax(x4, s[0], out_bf16=v == "dotbf16", threads=threads)
    if v.startswith("grp8"):
        # grp8 | grp8s<sub> | grp8s<sub>u<unroll>
        unroll, rest = 1, v[4:]
        if rest.startswith("s"):
            parts = rest[1:].split("u")
            int(parts[0])
            if len(parts) > 1:
                unroll = int(parts[1])
        elif rest:
            raise ValueError(f"unknown variant {v!r}")
        return lambda s: pk.kloop_assign(x4, s[0], s[1], slots=8, unroll=unroll, threads=threads)
    if v in VPU_UNROLL:
        return lambda s: pk.kloop_assign(x4, s[0], s[1], slots=1, fused=v == "vpu_fused",
                                         unroll=VPU_UNROLL[v], threads=threads)
    raise ValueError(f"unknown variant {v!r}")


def main(argv=None, *, device="cuda", shape=(H, W)) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    dev = setup_device(device)
    print(device_line(dev), flush=True)
    P = shape[0] * shape[1]
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.random((P, 3), dtype=np.float32), device=dev)
    pals = torch.as_tensor(rng.random((SETS, POP, K, 3)).astype(np.float32), device=dev)
    print(f"{shape[1]}x{shape[0]} = {P / 1e6:.2f} Mpix, K={K}, pop={POP}")
    c4s, o4s = pk.pack_palette(pals, pals)
    sets = list(zip(c4s, o4s))
    x4 = pack_pixels(feats)
    variants = argv[0].split(",") if argv else ["cur", "grp8"]
    blocks = [int(b) for b in (argv[1].split(",") if len(argv) > 1 else ["256"])]
    out = {}
    for threads in blocks:
        for v in variants:
            before = launch_counts()
            ms = ms_per_call(variant_fn(v, x4, threads), sets, dev)
            out[(threads, v)] = {"ms": ms, "launches": launch_counts(before)}
            print(f"threads {threads:5d} {v:10s} {ms:8.3f} ms/call  {POP * P / ms / 1e3:7.0f} Mpix/s",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
