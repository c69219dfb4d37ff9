"""The flagship's forward step: the counterpart of `__graft_entry__.entry`.

`entry(device)` returns `(fn, (palettes,))`: `fn` is the population fitness
of one 256x256 image at K=64, population 4 (B1, then B2, on the card), and
returns the (4,) errors; one call is one annealing iteration's device work
for one image. The image and the palettes are drawn from
`np.random.default_rng(0)` in the JAX entry's order, so both entries see the
same numbers.

    python -m hybridquantization_tpu_torch.tools.entry [--cpu]

runs it once and prints the errors after the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args) of the flagship's population fitness on `device`."""
    from .. import QuantizationConfig, SWASAConfig
    from ..pipeline import _make_context, make_population_fitness, setup_device
    from ..scielab.filters import build_filters

    dev = setup_device(device)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=64, population=4))
    rng = np.random.default_rng(0)
    image = rng.random((256, 256, 3), dtype=np.float32)
    palettes = torch.as_tensor(rng.random((4, 64, 3), dtype=np.float32), device=dev)
    fitness = make_population_fitness(_make_context(image, build_filters(), cfg, dev), cfg)

    def fn(palettes: torch.Tensor) -> torch.Tensor:
        errors, _usage = fitness(palettes)
        return errors

    return fn, (palettes,)


def main(argv=None, *, device="cuda") -> int:
    from . import device_line

    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cpu" if "--cpu" in argv else device)
    fn, args = entry(dev)
    print(device_line(dev))
    print("entry OK:", fn(*args).cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
