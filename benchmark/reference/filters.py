"""S-CIELAB filter bank, a frozen copy of the numpy builder.

The plugin's ScielabProcessor constructor (ScielabProcessor.java:66-181):
separable Gaussian components for the three opponent channels from the
display's dpi and the viewing distance, with the upsample / convolve /
decimate correction below 224 samples a degree. Copied so that the
reference imports nothing of the program under test; only the numbers of
the filters are shared, never a tensor the program made.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MIN_SAMP_PER_DEG = 224  # ScielabProcessor.java:23

#: Component weights per opponent channel (ScielabProcessor.java:44-48).
WEIGHTS = (
    (1.00327, 0.114416, -0.117686),  # luminance
    (0.616725, 0.383275),            # red-green
    (0.567885, 0.432115),            # blue-yellow
)

#: Component halfwidths in degrees of visual angle (ScielabProcessor.java:49-53).
HALFWIDTHS = (
    (0.05, 0.225, 7.0),
    (0.0685, 0.826),
    (0.0920, 0.6451),
)


def gauss(halfwidth: float, width: int) -> np.ndarray:
    """Centered 1-D Gaussian that sums to one (ScielabProcessor.java:238-254).

    halfwidth is the full-width-at-half-maximum in samples; width is the
    number of sample points (odd).
    """
    alpha = 2.0 * math.sqrt(math.log(2.0)) / (halfwidth - 1.0)
    offset = width // 2
    x = np.arange(width, dtype=np.float64) - offset
    g = np.exp(-(alpha * alpha) * x * x).astype(np.float32)
    return g / np.float32(g.astype(np.float64).sum())


def _conv1d_same(data: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """'Same'-size 1-D correlation with zero boundary, centered at
    filt.length/2 (ScielabProcessor.java:185-201)."""
    n, m = len(data), len(filt)
    offset = m // 2
    out = np.zeros(n, dtype=np.float32)
    for i in range(n):
        lo = max(0, i - offset)
        hi = min(n, i + offset + 1)  # inclusive offset in the Java loop
        # filt index j+offset for j = (lo-i) .. (hi-1-i)
        out[i] = np.dot(
            filt[lo - i + offset : hi - i + offset].astype(np.float64),
            data[lo:hi].astype(np.float64),
        )
    return out


def _resize1d(src: np.ndarray, new_size: int) -> np.ndarray:
    """Zero-pad (or center-crop) to new_size (ScielabProcessor.java:203-220)."""
    pad = abs(new_size - len(src)) // 2
    if new_size > len(src):
        out = np.zeros(new_size, dtype=np.float32)
        out[pad : pad + len(src)] = src
        return out
    return src[pad : pad + new_size].copy()


def samples_per_degree(dpi: int, viewing_distance_cm: float) -> tuple[int, int]:
    """(sampPerDeg after upsampling, uprate) — ScielabProcessor.java:79-88."""
    spd = int(round(dpi / ((180.0 / math.pi) * math.atan(2.54 / viewing_distance_cm))))
    if spd < MIN_SAMP_PER_DEG:
        uprate = int(math.ceil(MIN_SAMP_PER_DEG / spd))
        spd *= uprate
    else:
        uprate = 1
    return spd, uprate


@dataclasses.dataclass(frozen=True)
class ScielabFilters:
    """Packed separable S-CIELAB filters.

    k1, k2: (taps, 3) float32 — Gaussian components 0 and 1, lane c holding
        the component for opponent channel c (packing per
        ImageManipulation.java:804-815).
    k3: (taps,) float32 — luminance channel's 3rd (negative-weight) component
        (ImageManipulation.java:816-826).
    k3_abs: (taps,) float32 — |k3|, used for the second (vertical) pass so the
        negative weight is applied exactly once (ScielabProcessor.java:174-178).
    samp_per_deg: effective samples/degree the bank was built at.
    """

    k1: np.ndarray
    k2: np.ndarray
    k3: np.ndarray
    k3_abs: np.ndarray
    samp_per_deg: int

    @property
    def taps(self) -> int:
        return self.k1.shape[0]

    @property
    def half_width(self) -> int:
        return self.k1.shape[0] // 2


def build_filters(dpi: int = 72, viewing_distance_cm: float = 45.0) -> ScielabFilters:
    """Build the opponent-channel filter bank (ScielabProcessor ctor)."""
    spd, uprate = samples_per_degree(dpi, viewing_distance_cm)

    # Halfwidths in pixels (ScielabProcessor.java:91-99).
    spreads = [[hw * spd for hw in row] for row in HALFWIDTHS]

    # Odd width, ~0.5 degree of visual angle (ScielabProcessor.java:102).
    width = int(math.ceil(spd / 2.0)) * 2 - 1

    # Per-channel separable components, scaled so the h x v outer product
    # carries weight w (ScielabProcessor.java:104-119).
    ofilters: list[list[np.ndarray]] = []
    for ch in range(3):
        comps = []
        for j in range(len(WEIGHTS[ch])):
            g = gauss(spreads[ch][j], width)
            w = WEIGHTS[ch][j]
            comps.append(g * np.float32(math.sqrt(abs(w)) * math.copysign(1.0, w)))
        ofilters.append(comps)

    # Upsample/convolve/decimate correction (ScielabProcessor.java:122-173).
    if uprate > 1:
        upcol = np.array(
            [(uprate - abs(uprate - i - 1)) / uprate for i in range(uprate * 2 - 1)],
            dtype=np.float32,
        )
        upcol = _resize1d(upcol, len(upcol) + width - 1)
        ups = [[_conv1d_same(f, upcol) for f in comps] for comps in ofilters]

        s = len(ups[0][0])
        mid = s // 2
        n_side = mid // uprate
        downs = mid + uprate * np.arange(-n_side, n_side + 1)
        ofilters = [[u[downs] for u in comps] for comps in ups]

    k3 = ofilters[0][2]
    k3_abs = np.abs(k3)
    k1 = np.stack([ofilters[0][0], ofilters[1][0], ofilters[2][0]], axis=-1)
    k2 = np.stack([ofilters[0][1], ofilters[1][1], ofilters[2][1]], axis=-1)
    return ScielabFilters(
        k1=np.ascontiguousarray(k1, dtype=np.float32),
        k2=np.ascontiguousarray(k2, dtype=np.float32),
        k3=np.ascontiguousarray(k3, dtype=np.float32),
        k3_abs=np.ascontiguousarray(k3_abs, dtype=np.float32),
        samp_per_deg=spd,
    )
