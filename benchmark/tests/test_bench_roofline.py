"""The frozen counts at the shapes of the cells."""

from __future__ import annotations

import pytest

from benchmark import roofline

K4 = 3840 * 2160


def test_b1_at_4k_k256_pop4_is_bound_by_its_compares():
    c = roofline.b1_counts(K4, 256, 4, "fp32")
    assert c["core_ops"] == K4 * 4 * 256
    assert roofline.bound_seconds(c) == pytest.approx(K4 * 4 * 256 / roofline.CUDA_CORE_OPS)
    assert roofline.bound_seconds(c) * 1e3 == pytest.approx(0.2538, abs=1e-3)


def test_b2_at_4k_pop4_is_bound_by_its_bytes():
    c = roofline.b2_counts(K4, 4, 21, "fp32")
    assert c["bytes"] == 4 * (15 * K4 + 4)
    assert roofline.bound_seconds(c) * 1e3 == pytest.approx(0.1486, abs=1e-3)
    # the tensor products alone: 0.059 ms
    assert c["tensor_flops"] / roofline.BF16_TENSOR_FLOPS * 1e3 == pytest.approx(0.0594, abs=1e-3)


def test_a_tensor_core_kernel_cannot_beat_the_bound():
    # a bf16-grade product costs a third of an fp32-grade one; bytes do not change
    fp32, bf16 = roofline.b2_counts(K4, 4, 97, "fp32"), roofline.b2_counts(K4, 4, 97, "bf16")
    assert fp32["tensor_flops"] == 3 * bf16["tensor_flops"]
    assert fp32["bytes"] == bf16["bytes"]


def test_batch_shapes():
    px = 16 * 1920 * 1080
    assert roofline.bound_seconds(roofline.b1_counts(px, 256, 4, "fp32")) * 1e3 == pytest.approx(1.015, abs=2e-3)
    assert roofline.bound_seconds(roofline.b2_counts(px, 4, 21, "fp32")) * 1e3 == pytest.approx(0.594, abs=2e-3)
