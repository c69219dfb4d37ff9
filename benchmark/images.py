"""Synthetic natural frames, made on the device.

The recipe of `hybridquantization_tpu_torch.synth.natural_image` in torch:
value-noise octaves with a 1/f amplitude (beta = 1), three independent
fields mixed into RGB with a luminance-dominant matrix, standardized and
squashed through a logistic. Each frame draws its lattices from its own
`torch.Generator` on the device, seeded from (corpus seed, frame index),
so a frame is the same bits for the same pair on any card, and making a
set costs a few calls per octave rather than a host pass per pixel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMAGE, ANNEAL = 0, 1


def derived_seed(seed: int, index: int, stream: int) -> int:
    """A 63-bit seed for (seed, item index, stream); any whole seed."""
    words = np.random.SeedSequence([seed % 2**64, index, stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _value_noise(h: int, w: int, gh: int, gw: int, gen: torch.Generator, device) -> torch.Tensor:
    g = torch.randn((gh + 1, gw + 1), generator=gen, device=device, dtype=torch.float64)
    y = torch.arange(h, device=device, dtype=torch.float64) * (gh / h)
    x = torch.arange(w, device=device, dtype=torch.float64) * (gw / w)
    y0 = torch.clamp(y.long(), max=gh - 1)
    x0 = torch.clamp(x.long(), max=gw - 1)
    ty = (y - y0)[:, None]
    tx = (x - x0)[None, :]
    ty, tx = ty * ty * (3.0 - 2.0 * ty), tx * tx * (3.0 - 2.0 * tx)
    rows0, rows1 = g[y0], g[y0 + 1]
    top = rows0[:, x0] + (rows0[:, x0 + 1] - rows0[:, x0]) * tx
    bot = rows1[:, x0] + (rows1[:, x0 + 1] - rows1[:, x0]) * tx
    return top + (bot - top) * ty


def natural_image(h: int, w: int, gen: torch.Generator, device, beta: float = 1.0) -> torch.Tensor:
    """(h, w, 3) float32 in [0, 1] on `device`."""
    n_oct = max(int(math.log2(min(h, w))) - 1, 1)
    fields = torch.zeros((3, h, w), dtype=torch.float64, device=device)
    for o in range(n_oct):
        gh = min(2 ** (o + 1), h)
        gw = min(max(int(round(gh * w / h)), 2), w)
        amp = float(2.0**o) ** (-beta)
        for c in range(3):
            fields[c] += amp * _value_noise(h, w, gh, gw, gen, device)
    L, c1, c2 = fields
    mix = torch.stack([L + 0.35 * c1, L - 0.12 * c1 + 0.18 * c2, L - 0.30 * c2])
    mix = (mix - mix.mean()) / (mix.std(correction=0) + 1e-12)
    return torch.sigmoid(1.2 * mix).permute(1, 2, 0).to(torch.float32).contiguous()


def make_set(sizes: list[tuple[int, int]], seed: int, device) -> list[np.ndarray]:
    """The frames of corpus `seed`, one per (h, w) in `sizes`, as host arrays."""
    out = []
    for i, (h, w) in enumerate(sizes):
        gen = torch.Generator(device=device)
        gen.manual_seed(derived_seed(seed, i, IMAGE))
        out.append(natural_image(h, w, gen, device).cpu().numpy())
    return out
