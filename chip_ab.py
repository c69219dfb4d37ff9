#!/usr/bin/env python3
"""Time B1 and B3 of one checkout on fixed random inputs, to compare two
commits of the port on one GPU.

    python3 chip_ab.py PATH

PATH is the root of a checkout; its `hybridquantization_tpu_torch` is the
one imported (and built at first use). Run it for each checkout in turns
within one machine (parent, change, change, parent): times from two
machines do not compare. After the card's name and power limit it prints
one JSON line of milliseconds a call (CUDA events after warm-up) on random
inputs from seed 0, K=256:

  b1_first_f32_4k, b1_average_bf16_4k   B1 at 3840x2160, population 4
  b3_index_4k                           B3's nearest index, one palette
  lloyd_step_4k                         one Lloyd step, ops.assign.lloyd_step
  seeding_step_bucket_64x32768          one k-means Lloyd step of a bucket:
                                        16 images x 4 members on 2^15-bin
                                        histograms of random 1080p images
  seeding_step_image_4x32768            the same for one image's 4 members

A checkout whose B3 has no batched Lloyd step (`assign_kernel.lloyd_step`)
runs the problems one at a time through ops.kmeans.lloyd_steps_weighted,
as its engine did. Exits non-zero without a CUDA device.
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


def main(root: str) -> int:
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
    g = torch.Generator().manual_seed(0)
    px = torch.rand((2160 * 3840, 3), generator=g).to(dev)
    pals = torch.rand((4, 256, 3), generator=g).to(dev)
    opps = cs.srgb_to_opp(pals).contiguous()
    out = {"root": root}
    out["b1_first_f32_4k"] = ms(lambda: ak.assign_opp_usage_pop(px, pals, opps), 20)
    out["b1_average_bf16_4k"] = ms(
        lambda: ak.assign_opp_usage_pop(px, pals, opps, precision="bf16", tie_mode="average"), 20)
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
