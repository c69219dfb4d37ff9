"""Nearest-palette assignment, Lloyd polish and ordered dithering.

The torch form of `hybridquantization_tpu/ops/assign.py`, plain torch
around one kernel: every nearest-entry lookup is B3
(ops.assign_kernel.assign_idx), the hand-written kernel on a CUDA tensor
and its plain version on a CPU tensor. The K-way search is the matmul
expansion

    argmin_k ||p - c_k||^2 = argmax_k (p . c_k - ||c_k||^2 / 2)

The reference assigns by Euclidean distance in nonlinear sRGB with a
strict-less scan, so ties go to the first (lowest) index
(OptimizedConvolution.cl:147-199), and a NaN score never wins, as the
reference's strict comparison would skip it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import colorspace as cs
from .assign_kernel import assign_idx, nearest_scan


def nearest_palette(
    pixels: torch.Tensor, palette: torch.Tensor, precision: str = "f32x3"
) -> torch.Tensor:
    """(P,) int32 index of the nearest palette entry for each (P, 3) pixel,
    first index on ties: B3's index, with a pixel that has no winner (all
    scores NaN) sent to entry 0, as an argmax over its scores would.
    precision "bf16" scores as B1's bf16 mode does, in the plain scan (B3
    is fp32 in every mode, as in JAX)."""
    if precision == "bf16":
        return nearest_scan(pixels, palette, "bf16").clamp_min(0)
    return assign_idx(pixels, palette).clamp_min(0)


def palette_usage(idx: torch.Tensor, num_colors: int) -> torch.Tensor:
    """(K,) bool — whether any pixel selected each palette entry
    (the reference's usedColors flags, OptimizedConvolution.cl:169,193)."""
    return torch.bincount(idx, minlength=num_colors)[:num_colors] > 0


def quantize_image(image_hwc: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Replace each pixel by its nearest palette color (same feature space;
    ImageManipulation.java:770-798)."""
    H, W, F = image_hwc.shape
    idx = nearest_palette(image_hwc.reshape(-1, F), palette)
    return palette[idx].reshape(H, W, F)


# ---------------------------------------------------------------------------
# Lloyd polish (beyond-reference; the reference's anneal is its only optimizer)
# ---------------------------------------------------------------------------


def centroid_update(
    values: torch.Tensor,
    idx: torch.Tensor,
    palette: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Move each palette entry to the (weighted) mean of the rows assigned to
    it; entries no row selected keep their color. Rows with idx -1 (no
    winner) are dropped.

    Sums and totals accumulate in float64 and the mean is cast to float32
    at the end: on the card `index_add_` adds in no fixed order, and fp32
    sums would round differently from run to run, fp32 counts stop being
    exact above 2^24 rows per entry. In float64 both stay exact far beyond
    any image (integer totals to 2^53), so only the final cast rounds.
    """
    K = palette.shape[0]
    keep = idx >= 0
    seg = torch.where(keep, idx, 0).long()
    w = keep.double() if weights is None else torch.where(keep, weights.double(), 0.0)
    rows = torch.where(keep[:, None], values.double(), 0.0) * w[:, None]
    sums = torch.zeros((K, values.shape[1]), dtype=torch.float64, device=values.device)
    sums.index_add_(0, seg, rows)
    tot = torch.zeros(K, dtype=torch.float64, device=values.device).index_add_(0, seg, w)
    mean = (sums / tot.clamp_min(1.0)[:, None]).to(torch.float32)
    return torch.where(tot[:, None] > 0, mean, palette)


def lloyd_step(pixels: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """One Lloyd (k-means) step: move each palette entry to the centroid of
    its assigned pixels; entries no pixel selected keep their color.

    The assignment is the B3 kernel (ops.assign_kernel.assign_idx) on a
    CUDA tensor and its plain version on a CPU tensor. A pixel with no
    winner (all scores NaN) gets -1 there and is dropped from the sums and
    counts, as the Pallas kernel's out-of-range index K_pad is dropped by
    segment_sum. Lloyd steps are monotone in assignment-space MSE.
    """
    return centroid_update(pixels, assign_idx(pixels, palette), palette)


def lloyd_polish(pixels: torch.Tensor, palette: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """`iters` Lloyd steps (see lloyd_step)."""
    for _ in range(iters):
        palette = lloyd_step(pixels, palette)
    return palette


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

    method: "exact" runs per-pixel Lloyd steps (lloyd_polish, through B3 on
    the card); "hist" runs them on a 2^18-bin weighted histogram of the sRGB
    values (bits=6; for "lab" the bin centers are converted to CIELAB and
    the steps run there); "auto" = hist from 2^20 pixels on, exact below.
    """
    from . import kmeans  # kmeans imports this module

    if method == "auto":
        method = "hist" if pixels_srgb.shape[0] >= (1 << 20) else "exact"
    if method not in ("hist", "exact"):
        raise ValueError(f"unknown polish method {method!r}")
    if space == "lab":
        if method == "hist":
            counts, centers = kmeans.color_histogram(pixels_srgb, 6)
            out = kmeans.lloyd_steps_weighted(
                counts,
                cs.srgb_to_lab(centers, whitepoint),
                cs.srgb_to_lab(palette_srgb, whitepoint),
                iters,
            )
        else:
            out = lloyd_polish(
                cs.srgb_to_lab(pixels_srgb, whitepoint),
                cs.srgb_to_lab(palette_srgb, whitepoint),
                iters,
            )
        return torch.clamp(cs.lab_to_srgb(out, whitepoint), 0.0, 1.0)
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
