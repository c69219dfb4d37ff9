"""Frozen operation and byte counts of the fitness kernels, and the peaks
of one H100 they are held to.

Each count is a function of the shapes alone (pixels, K, population,
taps, precision), whatever kernel implements the arithmetic, so a share
reads the same work before and after a change. The bound of a call is
the least time any implementation of that arithmetic could take, the
largest of

- bytes / HBM bandwidth, each input byte read once and each output byte
  written once;
- the products at the fastest rate that can deliver them at the stated
  precision: an fp32-grade product as the three hi/lo bf16 products
  (hi*hi, hi*lo, lo*hi) at the dense bf16 tensor rate, a bf16 product as
  one;
- the comparisons of an argmin at the CUDA cores' rate of one operation
  per lane and clock.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3; 132 SMs x 128 fp32
lanes x 1.98 GHz = 33.45e12 lane operations a second on the CUDA cores
(67 TFLOP/s as fused multiply-adds).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
CUDA_CORE_OPS = 132 * 128 * 1.98e9
F32 = 4

#: filters of the S-CIELAB bank in each pass (k1 and k2 of three channels, k3)
SCIELAB_FILTERS = 7


def _products(precision: str) -> int:
    """bf16 tensor products that one product of `precision` costs."""
    return 1 if precision == "bf16" else 3


def b1_counts(pixels: int, colors: int, population: int, precision: str) -> dict:
    """B1, the population's assignment: every pixel's nearest entry of each
    member's palette (a 3-term score against every entry, the argmin),
    writing each pixel's winning opponent colour and each entry's count."""
    pairs = pixels * population * colors
    return {
        "tensor_flops": 2 * 3 * pairs * _products(precision),
        "core_ops": pairs,
        "bytes": F32 * (3 * pixels + 2 * 3 * population * colors
                        + 3 * population * pixels + population * colors),
    }


def b2_counts(pixels: int, population: int, taps: int, precision: str) -> dict:
    """B2, the fused S-CIELAB Delta-E: each member's quantized opponent
    image through the 7-filter separable bank (two passes of `taps`), to
    CIELAB, Delta-E against the target, summed."""
    macs = population * pixels * SCIELAB_FILTERS * taps * 2
    return {
        "tensor_flops": 2 * macs * _products(precision),
        "core_ops": 0,
        "bytes": F32 * (3 * population * pixels + 3 * pixels + population),
    }


def bound_seconds(counts: dict) -> float:
    return max(counts["bytes"] / HBM_BYTES_PER_S,
               counts["tensor_flops"] / BF16_TENSOR_FLOPS,
               counts["core_ops"] / CUDA_CORE_OPS)
