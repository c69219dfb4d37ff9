"""One image's answer, as the harness keeps it for the comparison."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Record:
    """What one image of a finished job returned, kept on the host for the
    comparison with the reference (the error image may stay on the device
    until then)."""

    index: int
    anneal_palette: np.ndarray   # (K, 3) the search's palette
    fitness: float               # the fitness the search reports for it
    palette: np.ndarray          # (K, 3) the palette returned (polished, if any)
    quantized: np.ndarray        # (H, W, 3)
    mean_de: float | None = None
    viz: object = None           # (H, W) or (H, W, 3) error image, tensor or array
