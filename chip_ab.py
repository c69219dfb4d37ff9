#!/usr/bin/env python3
"""Time B1, B2 and B3 of one checkout on fixed random inputs, to compare two
commits of the port on one GPU.

    python3 chip_ab.py PATH [--only b2]

PATH is the root of a checkout; its `hybridquantization_tpu_torch` is the
one imported (and built at first use). Run it for each checkout in turns
within one machine (parent, change, change, parent): times from two
machines do not compare. After the card's name and power limit it prints
one JSON line of milliseconds a call (CUDA events after warm-up) on random
inputs from seed 0, K=256:

  b1_first_f32_4k, b1_average_bf16_4k   B1 at 3840x2160, population 4
  b2_f32_4k, b2_split_4k                B2 at 3840x2160, population 4, the
                                        default 21 taps, in the fp32 mode and
                                        in the split mode (the TPU's f32x3;
                                        null where the checkout has none)
  b3_index_4k                           B3's nearest index, one palette
  lloyd_step_4k                         one Lloyd step, ops.assign.lloyd_step
  seeding_step_bucket_64x32768          one k-means Lloyd step of a bucket:
                                        16 images x 4 members on 2^15-bin
                                        histograms of random 1080p images
  seeding_step_image_4x32768            the same for one image's 4 members

and the probe kernels at 4K/K256/pop4 on the probe scripts' seed-0 inputs
(chip_smoke.py's phase_probes draws them alike), through the wrappers'
calls, which a parent checkout takes as well:

  t3_dotf32                              split_rowmax (the control, timed first)
  t3_dotbf16                             split_rowmax, bf16 output
  t4_dotmax                              split_rowmax through kexp_assign
  t5_dense                               split_rowmax, minidot's dense candidates
  t6_mini128, t6_mini256                 split_rowmax per run (KC = 64)
  t1_vpu, t1_vpu_fused, t2_grp8          probe_kloop (T1, T2)
  t4_current, t4_avg                     split_assign through kexp_assign
  t7_run128, t7_run256                   split_assign per run (KC = 64)

A checkout whose B3 has no batched Lloyd step (`assign_kernel.lloyd_step`)
runs the problems one at a time through ops.kmeans.lloyd_steps_weighted,
as its engine did. With `--only b2` it times B2 alone. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys


def ms(fn, n: int) -> float:
    """Milliseconds a call, CUDA events over n calls after two."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def probes(torch, dev) -> dict:
    """Milliseconds a call of the probe kernels on the probe scripts' inputs."""
    import numpy as np

    from hybridquantization_tpu_torch.ops import probe_kernels as pk
    from hybridquantization_tpu_torch.tools import H, K, POP, W, kexp_assign, minidot_probe, pack_pixels

    P = H * W
    rng = np.random.default_rng(0)  # vpu_assign_exp and kexp_assign draw alike
    feats = torch.as_tensor(rng.random((P, 3), dtype=np.float32), device=dev)
    pals = torch.as_tensor(rng.random((8, POP, K, 3)).astype(np.float32), device=dev)
    x4 = pack_pixels(feats)
    c4, o4 = pk.pack_palette(pals[0], pals[0])
    rng = np.random.default_rng(0)  # minidot_probe
    xm = torch.as_tensor(rng.random((4, P), dtype=np.float32), device=dev)
    cd = torch.as_tensor(rng.random((8, POP, 4, K), dtype=np.float32)[0], device=dev)
    nr = minidot_probe.BLOCK // 128
    cm = {128: rng.random((8, POP, nr, 4, minidot_probe.KC), dtype=np.float32)[:1],
          256: rng.random((8, POP, nr // 2, 4, minidot_probe.KC), dtype=np.float32)[:1]}
    cr = {run: minidot_probe.per_run(torch.as_tensor(a, device=dev), P, run)[0] for run, a in cm.items()}
    calls = {  # the control first: what runs before a timing can move it
        "t3_dotf32": lambda: pk.split_rowmax(x4, c4),
        "t3_dotbf16": lambda: pk.split_rowmax(x4, c4, out_bf16=True),
        "t4_dotmax": lambda: kexp_assign.run_variant("dotmax", x4, c4, o4),
        "t5_dense": lambda: pk.split_rowmax(xm, cd),
        "t6_mini128": lambda: pk.split_rowmax(xm, cr[128], run=128),
        "t6_mini256": lambda: pk.split_rowmax(xm, cr[256], run=256),
        "t1_vpu": lambda: pk.kloop_assign(x4, c4, o4, slots=1, unroll=8),
        "t1_vpu_fused": lambda: pk.kloop_assign(x4, c4, o4, slots=1, fused=True, unroll=8),
        "t2_grp8": lambda: pk.kloop_assign(x4, c4, o4, slots=8, unroll=1),
        "t4_current": lambda: kexp_assign.run_variant("current", x4, c4, o4),
        "t4_avg": lambda: kexp_assign.run_variant("avg", x4, c4, o4),
        "t7_run128": lambda: pk.split_assign(xm, cr[128], cr[128], run=128, opp_parts=2),
        "t7_run256": lambda: pk.split_assign(xm, cr[256], cr[256], run=256, opp_parts=2),
    }
    return {name: ms(fn, 20) for name, fn in calls.items()}


def b2(torch, dev, g) -> dict:
    """Milliseconds a call of B2 at 4K/pop4 on random opponent images."""
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import fused_fitness as ff
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.scielab.transform import stacked_kernels

    h, w = 2160, 3840
    q = torch.movedim(cs.srgb_to_opp(torch.rand((4, h, w, 3), generator=g).to(dev)), -1, 1).contiguous()
    target = torch.movedim(cs.srgb_to_lab(torch.rand((h, w, 3), generator=g).to(dev)), -1, 0).contiguous()
    f = build_filters()
    kh, kv = stacked_kernels(f, False, dev), stacked_kernels(f, True, dev)
    args = (q, target, kh, kv, cs.WHITEPOINT_D65, "CIE76")
    host = {"taps_on_host": ff.kernel_taps(kh, kv)}
    split = "split" in getattr(ff, "CONV_PRECISIONS", ())
    return {"b2_f32_4k": ms(lambda: ff.fused_scielab_err_sums(*args, **host), 20),
            "b2_split_4k": ms(lambda: ff.fused_scielab_err_sums(*args, precision="split", **host), 20)
            if split else None}


def main(root: str, only: str = "") -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from hybridquantization_tpu_torch import colorspace as cs
    from hybridquantization_tpu_torch.ops import assign as ao
    from hybridquantization_tpu_torch.ops import assign_kernel as ak
    from hybridquantization_tpu_torch.ops import kmeans as km

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda")
    if only == "b2":
        print(json.dumps({"root": root, **b2(torch, dev, torch.Generator().manual_seed(1))}))
        return 0
    g = torch.Generator().manual_seed(0)
    px = torch.rand((2160 * 3840, 3), generator=g).to(dev)
    pals = torch.rand((4, 256, 3), generator=g).to(dev)
    opps = cs.srgb_to_opp(pals).contiguous()
    out = {"root": root}
    out["b1_first_f32_4k"] = ms(lambda: ak.assign_opp_usage_pop(px, pals, opps), 20)
    out["b1_average_bf16_4k"] = ms(
        lambda: ak.assign_opp_usage_pop(px, pals, opps, precision="bf16", tie_mode="average"), 20)
    out.update(b2(torch, dev, torch.Generator().manual_seed(1)))
    out["b3_index_4k"] = ms(lambda: ak.assign_idx(px, pals[0]), 20)
    out["lloyd_step_4k"] = ms(lambda: ao.lloyd_step(px, pals[0]), 10)
    images = torch.rand((16, 1080 * 1920, 3), generator=g).to(dev) * 0.8
    hists = [km.color_histogram(im, 5) for im in images]
    counts = torch.stack([h[0] for h in hists])
    centers = torch.stack([h[1] for h in hists])
    starts = torch.rand((16, 4, 256, 3), generator=g).to(dev)
    if hasattr(ak, "lloyd_step"):
        def bucket():
            return km.lloyd_steps_weighted(counts, centers, starts, 1)

        def image():
            return km.lloyd_steps_weighted(counts[0], centers[0], starts[0], 1)
    else:
        def bucket():
            return [km.lloyd_steps_weighted(counts[i], centers[i], starts[i, m], 1)
                    for i in range(16) for m in range(4)]

        def image():
            return [km.lloyd_steps_weighted(counts[0], centers[0], starts[0, m], 1) for m in range(4)]
    out["seeding_step_bucket_64x32768"] = ms(bucket, 5)
    out["seeding_step_image_4x32768"] = ms(image, 10)
    del px, images, hists, counts, centers, starts
    torch.cuda.empty_cache()
    out.update(probes(torch, dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 4) or (len(sys.argv) == 4 and sys.argv[2:] != ["--only", "b2"]):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], "b2" if len(sys.argv) == 4 else ""))
