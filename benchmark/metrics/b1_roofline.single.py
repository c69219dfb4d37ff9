"""b1_roofline.single: B1's share of its roofline bound inside the
`find_palette` spans (benchmark/roofline.py b1_counts; H100 SXM peaks at 700 W)."""

from benchmark import roofline
from benchmark.layers import kernel_pattern, roofline_share

#: B1 (ops/assign_kernel.assign_opp_usage_pop -> csrc/assign_pop.cu)
KERNELS = kernel_pattern("pack_kernel", "assign_pop_kernel")


def counts(span):
    precision = "bf16" if span["precision"] == "bf16" else "fp32"
    return roofline.b1_counts(span["pixels"] * span["images"], span["colors"], span["population"], precision)


def read(data):
    return roofline_share(data, "find_palette", KERNELS, counts)
