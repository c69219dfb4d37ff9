"""Histogram-weighted k-means palette initialization (beyond-reference).

The counterpart of `hybridquantization_tpu/ops/kmeans.py`. The reference
seeds every SWASA population member with uniform-random colors
(SWASA.java:40-52); with `init="kmeans"` each member instead starts from
its own weighted k-means solution on a static 2^(3*bits)-bin color
histogram ("Fast Color Quantization Using Weighted Sort-Means Clustering",
arXiv:1011.0093, PAPERS.md). Each Lloyd step assigns every bin to its
nearest entry (B3, ops.assign_kernel.assign_idx: the 3-term score written
out, so no matmul precision mode enters, first index on ties) and moves
entries to the count-weighted centroid of their bins
(ops.assign.centroid_update, in float64).

Plain torch but for B3; the random start draws from a `torch.Generator`, so its numbers
differ from `jax.random`'s (tests feed both packages the same palettes).
"""

from __future__ import annotations

import torch

from .assign import centroid_update
from .assign_kernel import assign_idx


def color_histogram(pixels: torch.Tensor, bits: int = 5):
    """(counts (B,) f32, centers (B, 3) f32) color histogram, B = 2^(3*bits).

    A pixel falls in bin (q0 * n + q1) * n + q2 with q = clip(int(pixels *
    n), 0, n - 1), n = 2^bits. centers hold the mean color of each bin's
    pixels (summed in float64); empty bins fall back to the geometric bin
    center with zero weight.
    """
    n = 1 << bits
    B = n**3
    q = torch.clamp((pixels * n).to(torch.int32), 0, n - 1).long()
    bin_id = (q[:, 0] * n + q[:, 1]) * n + q[:, 2]
    ids = torch.arange(B, device=pixels.device)
    grid = ((torch.stack([ids // (n * n), (ids // n) % n, ids % n], dim=-1) + 0.5) / n).float()
    counts = torch.bincount(bin_id, minlength=B).to(torch.float32)
    return counts, centroid_update(pixels, bin_id, grid)


def lloyd_steps_weighted(
    counts: torch.Tensor, centers: torch.Tensor, palette: torch.Tensor, iters: int
) -> torch.Tensor:
    """`iters` Lloyd steps on (counts, centers) from a given palette: every
    bin goes to its nearest entry, every entry to the count-weighted mean of
    its bins; entries with no bins keep their color."""
    for _ in range(iters):
        palette = centroid_update(centers, assign_idx(centers, palette), palette, counts)
    return palette


def weighted_start(generator: torch.Generator, counts: torch.Tensor, num_colors: int) -> torch.Tensor:
    """(K,) distinct bin indices drawn with probability proportional to
    their counts, without replacement.

    `jax.random.choice(replace=False, p=...)` as it is written there: a
    Gumbel top-k, here the first K of a stable descending sort of
    gumbel + log p. Empty bins have log p = -inf and rank last, ties going
    to the lower index, so an image with fewer occupied bins than K seeds
    the surplus entries at the lowest-index empty bins. (torch.multinomial
    without replacement raises in that case.)
    """
    B = counts.shape[0]
    if num_colors > B:
        raise ValueError(
            f"Cannot take a larger sample (size {num_colors}) than population (size {B})"
        )
    probs = counts / torch.clamp(torch.sum(counts), min=1.0)
    u = torch.rand(B, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    key = -torch.log(-torch.log(u)) + torch.log(probs)
    return torch.argsort(-key, stable=True)[:num_colors]


def weighted_kmeans(
    generator: torch.Generator,
    counts: torch.Tensor,
    centers: torch.Tensor,
    num_colors: int,
    iters: int = 25,
) -> torch.Tensor:
    """(K, 3) palette: Lloyd on histogram bins with counts as weights, from
    K bins drawn in proportion to their counts (weighted_start).

    Surplus entries seeded at empty grid centers attract no bins and stay
    put; SWASA's unused-color penalty handles them (SURVEY.md 2b).
    """
    start = weighted_start(generator, counts, num_colors)
    return lloyd_steps_weighted(counts, centers, centers[start], iters)


def lloyd_polish_hist(
    pixels: torch.Tensor, palette: torch.Tensor, iters: int = 10, bits: int = 6
) -> torch.Tensor:
    """Lloyd polish on a 2^(3*bits)-bin weighted histogram of the pixels:
    one pixel-sized scatter (the histogram) instead of one per step."""
    counts, centers = color_histogram(pixels, bits)
    return lloyd_steps_weighted(counts, centers, palette, iters)


def kmeans_init_palettes(
    generator: torch.Generator,
    pixels: torch.Tensor,
    num_colors: int,
    population: int,
    bits: int = 5,
    iters: int = 25,
) -> torch.Tensor:
    """(pop, K, 3) sRGB palettes: one weighted-k-means run per member, each
    from its own count-weighted random start, drawn from `generator` in
    member order."""
    counts, centers = color_histogram(pixels, bits)
    return torch.stack(
        [weighted_kmeans(generator, counts, centers, num_colors, iters) for _ in range(population)]
    )
