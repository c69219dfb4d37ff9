"""Annealing state.

The counterpart of `hybridquantization_tpu/swasa/state.py`: the tensors the
annealing loop carries, all on one device, plus the `torch.Generator` that
makes every draw (in place of the JAX key). A bucket of B images annealed
in lockstep carries the same fields with a leading image axis and a tuple
of B generators, one per image (the JAX batch engine's vmapped states).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SWASAState:
    """colors:         ([B,] pop, K, 3) accepted palettes, sRGB in [0, 1]
    current_errors: ([B,] pop) fitness of the accepted palettes
    best_colors:    ([B,] K, 3) best palette seen so far
    best_error:     ([B]) best fitness seen so far
    temperature:    ([B]) current annealing temperature
    iteration:      () int32, iterations completed (0 = only initial eval),
                    shared by the images of a bucket
    generator:      the generator of all later draws, on the same device;
                    for a bucket a tuple of B, one per image
    """

    colors: torch.Tensor
    current_errors: torch.Tensor
    best_colors: torch.Tensor
    best_error: torch.Tensor
    temperature: torch.Tensor
    iteration: torch.Tensor
    generator: torch.Generator | tuple[torch.Generator, ...]

    @property
    def population(self) -> int:
        return self.colors.shape[-3]

    @property
    def num_colors(self) -> int:
        return self.colors.shape[-2]


_TENSORS = ("colors", "current_errors", "best_colors", "best_error", "temperature", "iteration")


def state_to_numpy(state: SWASAState) -> dict:
    """Flatten a single-image state to a dict of host arrays; the generator
    as its state bytes beside the type of the device it draws on ("cpu" or
    "cuda")."""
    d = {k: getattr(state, k).cpu().numpy() for k in _TENSORS}
    d["generator"] = state.generator.get_state().numpy()
    d["generator_device"] = np.asarray(state.generator.device.type)
    return d


def state_from_numpy(d: dict, device=None) -> SWASAState:
    """The state from `state_to_numpy`'s dict, on `device`.

    A generator's state only restores on a generator of the same device
    type: a CPU generator's state is its Mersenne-Twister words, a CUDA
    generator's a seed and an offset, and neither stream can be continued on
    the other device. So `device` defaults to the saved generator's device
    type, and a `device` of another type raises a ValueError that names
    both: loading elsewhere would silently change the run's later draws.
    """
    saved = str(np.asarray(d["generator_device"]))
    device = torch.device(saved if device is None else device)
    if device.type != saved:
        raise ValueError(
            f"the state's generator was saved on a {saved} device and cannot "
            f"continue its stream on {device}; load it with device={saved!r}"
        )
    generator = torch.Generator(device=device)
    generator.set_state(torch.tensor(np.asarray(d["generator"], np.uint8)))
    return SWASAState(
        **{k: torch.tensor(np.asarray(d[k]), device=device) for k in _TENSORS},
        generator=generator,
    )
