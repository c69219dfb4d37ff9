"""Histogram-weighted k-means palette initialization (beyond-reference).

The counterpart of `hybridquantization_tpu/ops/kmeans.py`. The reference
seeds every SWASA population member with uniform-random colors
(SWASA.java:40-52); with `init="kmeans"` each member instead starts from
its own weighted k-means solution on a static 2^(3*bits)-bin color
histogram ("Fast Color Quantization Using Weighted Sort-Means Clustering",
arXiv:1011.0093, PAPERS.md). Each Lloyd step assigns every bin to its
nearest entry and moves entries to the count-weighted centroid of their
bins: B3's Lloyd-step mode (ops.assign_kernel.lloyd_step: the 3-term score
written out, so no matmul precision mode enters, first index on ties; the
centroid sums of ops.assign_kernel.centroid_update, in float64). JAX vmaps
the members (`ops/kmeans.py:151`) and a bucket's images
(`parallel/batch.py:28-38`); here they are the problem axes of one launch
a step.

Plain torch but for B3; the random start draws from a `torch.Generator`, so its numbers
differ from `jax.random`'s (tests feed both packages the same palettes).
"""

from __future__ import annotations

import torch

from ..metrics import span
from .assign_kernel import centroid_update, lloyd_step


def color_histogram(pixels: torch.Tensor, bits: int = 5):
    """(counts (B,) f32, centers (B, 3) f32) color histogram, B = 2^(3*bits);
    for (F, P, 3) pixels, (F, B) and (F, B, 3), one per image.

    A pixel falls in bin (q0 * n + q1) * n + q2 with q = clip(int(pixels *
    n), 0, n - 1), n = 2^bits. centers hold the mean color of each bin's
    pixels (summed in float64); empty bins fall back to the geometric bin
    center with zero weight. Several images go through one bincount and
    one sum, image f's bins offset by f * B.
    """
    n = 1 << bits
    B = n**3
    lead = pixels.shape[:-2]
    q = torch.clamp((pixels * n).to(torch.int32), 0, n - 1).long()
    bin_id = (q[..., 0] * n + q[..., 1]) * n + q[..., 2]
    images = 1
    if lead:
        images = pixels.shape[0]
        bin_id = bin_id + torch.arange(images, device=pixels.device)[:, None] * B
    ids = torch.arange(B, device=pixels.device)
    grid = ((torch.stack([ids // (n * n), (ids // n) % n, ids % n], dim=-1) + 0.5) / n).float()
    bin_id = bin_id.reshape(-1)
    counts = torch.bincount(bin_id, minlength=images * B).to(torch.float32)
    centers = centroid_update(pixels.reshape(-1, 3), bin_id, grid.repeat(images, 1))
    return counts.reshape(*lead, B), centers.reshape(*lead, B, 3)


def lloyd_steps_weighted(
    counts: torch.Tensor, centers: torch.Tensor, palette: torch.Tensor, iters: int
) -> torch.Tensor:
    """`iters` Lloyd steps on (counts, centers) from a given palette: every
    bin goes to its nearest entry, every entry to the count-weighted mean of
    its bins; entries with no bins keep their color.

    counts (B,) and centers (B, 3) with a (K, 3) palette or (M, K, 3)
    palettes; or a leading image axis, (F, B) and (F, B, 3), with (F, K, 3)
    or (F, M, K, 3). Returns the palettes shaped alike, every problem's
    step in one launch.
    """
    if centers.dim() == 2:
        counts, centers, pal = counts[None], centers[None], palette[None]
    else:
        pal = palette
    if pal.dim() == 3:
        pal = pal[:, None]
    for _ in range(iters):
        pal = lloyd_step(centers, pal, counts)
    return pal.reshape(palette.shape)


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
    generator,
    pixels: torch.Tensor,
    num_colors: int,
    population: int,
    bits: int = 5,
    iters: int = 25,
) -> torch.Tensor:
    """(pop, K, 3) sRGB palettes: one weighted-k-means run per member, each
    from its own count-weighted random start, drawn from `generator` in
    member order. For (F, P, 3) pixels `generator` is one generator per
    image and the result (F, pop, K, 3).

    Every start is drawn first (image by image, member by member: the
    draws of the member-by-member loop, since no Lloyd step draws), then
    the `iters` steps run over all of them at once, one launch a step.
    """
    with span("seeding"):
        counts, centers = color_histogram(pixels, bits)
        batched = pixels.dim() == 3
        gens = tuple(generator) if batched else (generator,)
        if not batched:
            counts, centers = counts[None], centers[None]
        starts = torch.stack([
            torch.stack([c[weighted_start(g, n, num_colors)] for _ in range(population)])
            for g, n, c in zip(gens, counts, centers, strict=True)
        ])
        out = lloyd_steps_weighted(counts, centers, starts, iters)
        return out if batched else out[0]
