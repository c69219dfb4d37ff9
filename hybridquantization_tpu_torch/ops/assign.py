"""Nearest-palette assignment, Lloyd polish and ordered dithering.

The torch form of `hybridquantization_tpu/ops/assign.py`, plain torch
around one kernel: every nearest-entry lookup and every Lloyd step is B3
(ops.assign_kernel: assign_idx, lloyd_step), the hand-written kernel on a
CUDA tensor and its plain version on a CPU tensor. The K-way search is the
matmul expansion

    argmin_k ||p - c_k||^2 = argmax_k (p . c_k - ||c_k||^2 / 2)

The reference assigns by Euclidean distance in nonlinear sRGB with a
strict-less scan, so ties go to the first (lowest) index
(OptimizedConvolution.cl:147-199), and a NaN score never wins, as the
reference's strict comparison would skip it.

Quantize and the polish take an optional leading image axis (the JAX batch
engine vmaps them, `parallel/batch.py:41-50`): a bucket's images, each with
its own palette, go through one B3 launch a lookup or a Lloyd step.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import colorspace as cs
from .assign_kernel import assign_idx, lloyd_step, nearest_scan


def per_image(fn, x: torch.Tensor, batched: bool) -> torch.Tensor:
    """fn over a stack, image by image when it has a leading image axis
    (`batched`) on the CPU.

    There torch evaluates pow with SIMD code for the aligned elements of a
    tensor and with libm for its tail, which round differently, so an
    element's last bit depends on its position; mapping each image on its
    own keeps an image's numbers independent of its bucket (converted in one
    call, a bucket's fitness differs from an image's own in the last bit:
    tests/test_torch_batch.py::test_batched_fitness_is_bit_equal_to_single_images).
    A CUDA kernel computes every element alike, so on the card the bucket
    converts in one call (tests/test_torch_cuda.py holds it bit-equal there).
    """
    if batched and x.device.type == "cpu":
        return torch.stack([fn(i) for i in x])
    return fn(x)


def nearest_palette(
    pixels: torch.Tensor, palette: torch.Tensor, precision: str = "f32x3"
) -> torch.Tensor:
    """(P,) int32 index of the nearest palette entry for each (P, 3) pixel,
    first index on ties: B3's index, with a pixel that has no winner (all
    scores NaN) sent to entry 0, as an argmax over its scores would.
    (F, P, 3) pixels with (F, K, 3) palettes give (F, P), each image against
    its own palette, in one launch. precision "bf16" scores as B1's bf16
    mode does, in the plain scan (B3 is fp32 in every mode, as in JAX)."""
    if precision == "bf16":
        return nearest_scan(pixels, palette, "bf16").clamp_min(0)
    if pixels.dim() == 3:
        return assign_idx(pixels, palette[:, None])[:, 0].clamp_min(0)
    return assign_idx(pixels, palette).clamp_min(0)


def palette_usage(idx: torch.Tensor, num_colors: int) -> torch.Tensor:
    """(K,) bool — whether any pixel selected each palette entry
    (the reference's usedColors flags, OptimizedConvolution.cl:169,193)."""
    return torch.bincount(idx, minlength=num_colors)[:num_colors] > 0


def _take(palette: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """palette[idx] row by row: (K, C)[(P,)] or (F, K, C)[(F, P)]."""
    if idx.dim() == 2:
        return torch.gather(palette, 1, idx.long()[..., None].expand(-1, -1, palette.shape[-1]))
    return palette[idx]


def quantize_image(image_hwc: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Replace each pixel by its nearest palette color (same feature space;
    ImageManipulation.java:770-798). (F, H, W, C) images with (F, K, C)
    palettes: each image through its own palette."""
    C = image_hwc.shape[-1]
    flat = image_hwc.reshape(*image_hwc.shape[:-3], -1, C)
    return _take(palette, nearest_palette(flat, palette)).reshape(image_hwc.shape)


def quantize_in_space(images: torch.Tensor, palettes: torch.Tensor, space: str, whitepoint) -> torch.Tensor:
    """(H, W, 3) sRGB image through its (K, 3) sRGB palette, or (F, H, W, 3)
    through (F, K, 3), the nearest entry taken in `space` ("srgb" or
    "lab"); returns sRGB. One B3 launch for all images."""
    if space == "srgb":
        return quantize_image(images, palettes)
    if space != "lab":
        raise ValueError(f"unknown assignment space {space!r}")
    batched = images.dim() == 4
    lab = lambda x: cs.srgb_to_lab(x, whitepoint)  # noqa: E731
    feats = per_image(lab, images, batched)
    idx = nearest_palette(feats.reshape(*images.shape[:-3], -1, 3), per_image(lab, palettes, batched))
    return _take(palettes, idx).reshape(images.shape)


# ---------------------------------------------------------------------------
# Lloyd polish (beyond-reference; the reference's anneal is its only optimizer)
# ---------------------------------------------------------------------------


def lloyd_polish(pixels: torch.Tensor, palette: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """`iters` Lloyd steps (ops.assign_kernel.lloyd_step: each entry to the
    centroid of its nearest pixels, float64 sums; entries no pixel selected
    keep their colour; a pixel with no winner is dropped, as the Pallas
    kernel's out-of-range K_pad is dropped by segment_sum). (P, 3) pixels
    with a (K, 3) palette, or (F, P, 3) with (F, K, 3): each image's palette
    on its own pixels, one launch a step. Lloyd steps are monotone in
    assignment-space MSE."""
    batched = pixels.dim() == 3
    pal = palette[:, None] if batched else palette
    for _ in range(iters):
        pal = lloyd_step(pixels, pal)
    return pal[:, 0] if batched else pal


def polish_palette(
    pixels_srgb: torch.Tensor,
    palette_srgb: torch.Tensor,
    space: str,
    whitepoint,
    iters: int,
    method: str = "auto",
) -> torch.Tensor:
    """Lloyd-polish an sRGB palette in the given assignment space.

    "lab" converts to CIELAB, polishes there, and maps back with gamut
    clamping; "srgb" polishes directly. Always returns sRGB in [0, 1].
    (P, 3) pixels with a (K, 3) palette, or (F, P, 3) with (F, K, 3): each
    image's palette on its own pixels, one B3 launch a Lloyd step.

    method: "exact" runs per-pixel Lloyd steps (lloyd_polish); "hist" runs
    them on a 2^18-bin weighted histogram of the sRGB values (bits=6; for
    "lab" the bin centers are converted to CIELAB and the steps run there);
    "auto" = hist from 2^20 pixels an image on, exact below.
    """
    from . import kmeans  # kmeans imports this module

    if method == "auto":
        method = "hist" if pixels_srgb.shape[-2] >= (1 << 20) else "exact"
    if method not in ("hist", "exact"):
        raise ValueError(f"unknown polish method {method!r}")
    batched = pixels_srgb.dim() == 3
    if space == "lab":
        lab = lambda x: cs.srgb_to_lab(x, whitepoint)  # noqa: E731
        pal = per_image(lab, palette_srgb, batched)
        if method == "hist":
            counts, centers = kmeans.color_histogram(pixels_srgb, 6)
            out = kmeans.lloyd_steps_weighted(counts, per_image(lab, centers, batched), pal, iters)
        else:
            out = lloyd_polish(per_image(lab, pixels_srgb, batched), pal, iters)
        out = per_image(lambda x: cs.lab_to_srgb(x, whitepoint), out, batched)
        return torch.clamp(out, 0.0, 1.0)
    if space != "srgb":
        raise ValueError(f"unknown assignment space {space!r}")
    if method == "hist":
        out = kmeans.lloyd_polish_hist(pixels_srgb, palette_srgb, iters)
    else:
        out = lloyd_polish(pixels_srgb, palette_srgb, iters)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Ordered dithering (beyond-reference)
# ---------------------------------------------------------------------------


def bayer_matrix(order: int = 3, device="cpu") -> torch.Tensor:
    """(2^order, 2^order) ordered-dither thresholds in [-0.5, 0.5).

    Recursive Bayer construction; mean-zero so dithering adds no DC bias.
    """
    m = np.zeros((1, 1), np.float32)
    for _ in range(order):
        m = np.block([
            [4 * m + 0, 4 * m + 2],
            [4 * m + 3, 4 * m + 1],
        ])
    size = m.shape[0]
    # (k + 0.5)/n^2 - 0.5 centers the threshold set exactly at zero mean.
    return torch.as_tensor(((m + 0.5) / (size * size) - 0.5).astype(np.float32), device=device)


def dither_perturbation(
    image_hwc: torch.Tensor, palette: torch.Tensor, strength: float, order: int = 3
) -> torch.Tensor:
    """Image + tiled mean-zero Bayer thresholds scaled by palette spacing
    (the mean distance from each entry to its nearest other entry)."""
    H, W, _ = image_hwc.shape
    K = palette.shape[0]
    bayer = bayer_matrix(order, image_hwc.device)
    n = bayer.shape[0]
    rows = torch.arange(H, device=image_hwc.device) % n
    cols = torch.arange(W, device=image_hwc.device) % n
    tiles = bayer[rows[:, None], cols[None, :]]  # (H, W)
    d2 = torch.sum((palette[:, None, :] - palette[None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(K, device=palette.device) * 1e9
    spacing = torch.mean(torch.sqrt(torch.min(d2, dim=-1).values))
    return image_hwc + (strength * spacing) * tiles[..., None]


def quantize_image_dithered(
    image_hwc: torch.Tensor, palette: torch.Tensor, strength: float = 1.0, order: int = 3
) -> torch.Tensor:
    """Ordered (Bayer) dithered nearest-palette quantization: each pixel is
    perturbed by a tiled mean-zero threshold matrix scaled by the palette
    spacing before the nearest lookup (spatially stable and fully parallel,
    unlike error diffusion). strength=1 spreads the thresholds over the
    mean nearest-neighbor distance between palette entries."""
    H, W, F = image_hwc.shape
    perturbed = dither_perturbation(image_hwc, palette, strength, order)
    idx = nearest_palette(perturbed.reshape(-1, F), palette)
    return palette[idx].reshape(H, W, F)
