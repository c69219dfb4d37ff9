"""b2_roofline.batch: B2's share of its roofline bound inside the
`find_palettes` spans (benchmark/roofline.py b2_counts; H100 SXM peaks at 700 W)."""

from benchmark import roofline
from benchmark.layers import kernel_pattern, roofline_share

#: B2 (ops/fused_fitness.fused_scielab_err_sums -> csrc/fused_fitness.cu,
#: csrc/band_fitness.cu, the partials' reduce of csrc/fitness_common.cuh)
KERNELS = kernel_pattern("fused_kernel", "hpass_kernel", "vpass_de_kernel", "band_kernel", "reduce_kernel")


def counts(span, taps):
    precision = "bf16" if span["precision"] == "bf16" else "fp32"
    return roofline.b2_counts(span["pixels"] * span["images"], span["population"], taps, precision)


def read(data):
    return roofline_share(data, "find_palettes", KERNELS, lambda s: counts(s, data.taps))
