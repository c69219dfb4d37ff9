"""Separable 1-D convolution with half-sample symmetric reflection.

The plain torch form of the reference's two-pass separable convolution
(OptimizedConvolution.cl:2-74) and of `hybridquantization_tpu/ops/conv.py`.
Borders mirror by index, as the reference does (OptimizedConvolution.cl:21-27):
offset -1 reads sample 0 and offset n reads sample n-1 (half-sample
reflection). `torch.nn.functional.pad(mode="reflect")` reflects about the
edge sample instead, and a cuDNN convolution would run in TF32 on the GPU, so
the filter is an index gather followed by one multiply-add per tap in fp32.
This is also the plain version the fused fitness kernel is held to.
"""

from __future__ import annotations

import torch


def mirror_index(n: int, half: int, device=None) -> torch.Tensor:
    """Source index of each sample in [-half, n + half) under half-sample
    reflection; needs half <= n (one reflection)."""
    if half > n:
        raise ValueError(f"filter half-width {half} exceeds the axis length {n}")
    i = torch.arange(-half, n + half, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - i - 1, i)


def conv1d_valid(x: torch.Tensor, kernels: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel 1-D filter along one spatial axis in valid mode.

    Args:
      x: (..., C, H, W) float32 image whose `axis` holds taps - 1 samples of
        context beyond the n output samples (half on each side).
      kernels: (C, taps) filters; channel c uses kernels[c].
      axis: -2 (or the index of H) or -1 (W).

    Returns:
      (..., C, H, W) with `axis` n long: out[j] = sum_t k[t] * x[j + t],
      accumulated in tap order (a cross-correlation, like the reference).
    """
    axis = axis % x.dim()
    if axis not in (x.dim() - 2, x.dim() - 1):
        raise ValueError("axis must be one of the two trailing spatial axes")
    C, taps = kernels.shape
    if x.shape[-3] != C:
        raise ValueError(f"{x.shape[-3]} channels but {C} kernels")
    n = x.shape[axis] - taps + 1
    kv = kernels.to(device=x.device, dtype=x.dtype).view(C, taps, 1, 1)
    out = kv[:, 0] * x.narrow(axis, 0, n)
    for t in range(1, taps):
        out += kv[:, t] * x.narrow(axis, t, n)
    return out


def conv1d_symmetric(x: torch.Tensor, kernels: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel 1-D filter along one spatial axis, mirrored at both ends.

    Args:
      x: (..., C, H, W) float32 image; any leading batch dims.
      kernels: (C, taps) filters, taps odd; channel c uses kernels[c].
      axis: -2 (or the index of H) to filter vertically, -1 (W) horizontally.

    Returns:
      (..., C, H, W) filtered image. out[j] = sum_t k[t] * x[mirror(j - half + t)]
      accumulated in tap order (a cross-correlation, like the reference).
    """
    axis = axis % x.dim()
    if axis not in (x.dim() - 2, x.dim() - 1):
        raise ValueError("axis must be one of the two trailing spatial axes")
    half = kernels.shape[1] // 2
    xp = x.index_select(axis, mirror_index(x.shape[axis], half, x.device))
    return conv1d_valid(xp, kernels, axis)


def separable_conv2d_symmetric(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Full separable per-channel convolution of a (..., C, H, W) image:
    horizontal, then vertical, each mirrored at both ends (conv1d_symmetric)."""
    return conv1d_symmetric(conv1d_symmetric(x, kernels, axis=-1), kernels, axis=-2)
