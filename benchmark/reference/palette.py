"""Palette arithmetic written out plainly: nearest entry, the SWASA
fitness, the Lloyd polish and quantization.

Semantics are those of the plugin and of the engine's documented
beyond-reference stages:

- nearest entry: Euclidean distance in sRGB, the lowest index on ties
  (OptimizedConvolution.cl:147-199);
- fitness of a palette: the mean S-CIELAB Delta-E between the image and
  the image with every pixel replaced by its nearest entry, plus `delta`
  for each entry no pixel chose (SWASA.java:74-82);
- Lloyd polish: each step moves every entry to the (weighted) mean of the
  rows nearest to it, an entry no weight chose keeping its colour; from
  2^20 pixels an image on the rows are the 2^18 bins of a 6-bit colour
  histogram (bin of a pixel: clip(floor(64 v), 0, 63) per channel, the
  bin's mean colour weighted by its count), below that every pixel; the
  polished palette is clipped to [0, 1].

Every function works in blocks of rows so a 4K frame at K=256 fits.
"""

from __future__ import annotations

import torch

from . import color, scielab
from .filters import ScielabFilters
from .precision import Precision

BLOCK = 1 << 18
HIST_BITS = 6
HIST_FROM_PIXELS = 1 << 20


def _scores(p: torch.Tensor, pal: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(rows, K) squared distances up to a per-row constant: |c|^2 - 2 p.c
    (products in `prec`), so the smallest is the nearest."""
    c = prec.operand(pal)
    return (c * c).sum(-1)[None, :] - 2.0 * (prec.operand(p) @ c.T)


def nearest(pixels: torch.Tensor, pal: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(P,) int64 index of each (P, 3) row's nearest entry of (K, 3),
    the lowest index on ties."""
    pixels, pal = prec.cast(pixels), prec.cast(pal).to(pixels.device)
    return torch.cat([torch.argmin(_scores(b, pal, prec), dim=1) for b in pixels.split(BLOCK)])


def quantize(image_hwc, pal, prec: Precision) -> torch.Tensor:
    """(H, W, 3): every pixel replaced by its nearest entry."""
    image = prec.cast(image_hwc)
    pal = prec.cast(pal).to(image.device)
    return pal[nearest(image.reshape(-1, 3), pal, prec)].reshape(image.shape)


def fitness(image_hwc, pal, target_lab, filters: ScielabFilters, whitepoint: str, delta: float,
            kind: str, prec: Precision) -> float:
    """The SWASA fitness of one palette against the image's S-CIELAB."""
    image = prec.cast(image_hwc)
    pal = prec.cast(pal).to(image.device)
    idx = nearest(image.reshape(-1, 3), pal, prec)
    unused = int((torch.bincount(idx, minlength=pal.shape[0]) == 0).sum())
    q_opp = color.srgb_to_opp(pal, prec)[idx].reshape(image.shape)
    q_lab = color.opp_to_lab(scielab.filter_opp(q_opp, filters, prec), whitepoint, prec)
    return float(color.delta_e(target_lab, q_lab, kind).mean()) + delta * unused


def histogram(pixels: torch.Tensor, bits: int, prec: Precision):
    """(counts (B,), means (B, 3)) of the 2^(3 bits)-bin colour histogram;
    an empty bin has count 0 and its geometric centre."""
    n = 1 << bits
    pixels = prec.cast(pixels)
    q = torch.clamp(torch.floor(pixels * n), 0, n - 1).long()
    bins = (q[:, 0] * n + q[:, 1]) * n + q[:, 2]
    counts = torch.bincount(bins, minlength=n**3).to(torch.float64)
    sums = torch.zeros((n**3, 3), dtype=torch.float64, device=pixels.device)
    sums.index_add_(0, bins, pixels.to(torch.float64))
    ids = torch.arange(n**3, device=pixels.device)
    centre = (torch.stack([ids // (n * n), (ids // n) % n, ids % n], dim=-1) + 0.5) / n
    means = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centre)
    return counts.to(prec.dtype), means.to(prec.dtype)


def lloyd_step(rows: torch.Tensor, weights, pal: torch.Tensor, prec: Precision) -> torch.Tensor:
    idx = nearest(rows, pal, prec)
    w = torch.ones(rows.shape[0], dtype=prec.dtype, device=rows.device) if weights is None else weights
    tot = torch.zeros(pal.shape[0], dtype=prec.dtype, device=rows.device).index_add_(0, idx, w)
    sums = torch.zeros_like(pal).index_add_(0, idx, rows * w[:, None])
    return torch.where(tot[:, None] > 0, sums / tot.clamp_min(1e-30)[:, None], pal)


def polish(image_hwc, pal, iters: int, prec: Precision) -> torch.Tensor:
    """`iters` Lloyd steps in sRGB from `pal`, clipped to [0, 1]."""
    pixels = prec.cast(image_hwc).reshape(-1, 3)
    pal = prec.cast(pal).to(pixels.device)
    if pixels.shape[0] >= HIST_FROM_PIXELS:
        weights, rows = histogram(pixels, HIST_BITS, prec)
    else:
        weights, rows = None, pixels
    for _ in range(iters):
        pal = lloyd_step(rows, weights, pal, prec)
    return pal.clamp(0.0, 1.0)


def quantize_gap(image_hwc, out_hwc, pal) -> float:
    """The widest gap, in squared sRGB distance computed in float64, by
    which a pixel of `out_hwc` lies farther from its source pixel than the
    nearest entry of `pal` does; infinite where an output pixel is no
    entry of `pal`."""
    pixels = torch.as_tensor(image_hwc).to(torch.float64).reshape(-1, 3)
    out = torch.as_tensor(out_hwc).to(torch.float64).reshape(-1, 3).to(pixels.device)
    pal = torch.as_tensor(pal).to(torch.float64).to(pixels.device)
    worst = 0.0
    for p, o in zip(pixels.split(BLOCK), out.split(BLOCK)):
        member = ((o[:, None, :] == pal[None, :, :]).all(-1)).any(-1)
        if not bool(member.all()):
            return float("inf")
        d_out = ((p - o) ** 2).sum(-1)
        d_best = ((p[:, None, :] - pal[None, :, :]) ** 2).sum(-1).amin(1)
        worst = max(worst, float((d_out - d_best).max()))
    return worst
