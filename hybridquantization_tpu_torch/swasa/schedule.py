"""SWASA (simulated annealing with adaptive step width) schedule math.

The formulas of `hybridquantization_tpu/swasa/schedule.py` (SWASA.java),
on torch tensors. Where the JAX functions take a PRNG key, these take their
uniform draws as tensors, so a test can feed both packages the same numbers;
`random_palettes` and `draw_step` make them from a `torch.Generator` on the
device, or from a sequence of generators, one per image of a bucket: each
image then draws from its own generator exactly what a single-image run
seeded alike would draw, and the draws are stacked on a leading image axis
(JAX's per-image keys, `parallel/batch.py:215-222`).

  - temperature: T <- T*alpha when ite % iTc == 0, from T0 (SWASA.java:84-89)
  - adaptive max step width: s(i) = 2*s0 / (1 + exp(beta*i/imax)), applied in
    [0,1] RGB space as s(i)/256 (SWASA.java:69-72,92)
  - proposal: per-channel U(-1,1)*s(i)/256, clamped to [0,1] (SWASA.java:91-106)
  - acceptance: dE <= 0 or exp(-dE/T) > U(0,1) (SWASA.java:54-67)
  - convergence keep-probability:
    -tanh((i - convDelay*imax)/(convSpread*imax))/2 + 0.5 (SWASA.java:59-62)
  - unused-color penalty: delta per never-used palette entry (SWASA.java:74-82)
"""

from __future__ import annotations

from typing import Sequence, Union

import torch


def max_step_width(iteration, s0, beta, imax):
    """Adaptive maximum step width s(i) (SWASA.java:69-72)."""
    return 2.0 * s0 / (1.0 + torch.exp(beta * iteration / imax))


def cool_temperature(temperature, iteration, i_tc, alpha):
    """Geometric cooling every i_tc iterations (SWASA.java:84-89)."""
    return torch.where(iteration % i_tc == 0, temperature * alpha, temperature)


def propose(colors, iteration, s0, beta, imax, noise):
    """Perturb every channel of every palette color (SWASA.java:91-101).

    colors: (..., K, 3) in [0, 1]; noise: same shape, U(-1, 1).
    """
    step = max_step_width(iteration, s0, beta, imax) / 256.0
    return torch.clamp(colors + noise * step, 0.0, 1.0)


def accept(delta_error, temperature, u):
    """Metropolis acceptance (SWASA.java:54-57); u: U(0,1) like delta_error."""
    return (delta_error <= 0.0) | (torch.exp(-delta_error / temperature) > u)


def keep_probability(iteration, conv_delay, conv_spread, imax):
    """Probability a population member keeps its own state (SWASA.java:59-62)."""
    return -torch.tanh((iteration - conv_delay * imax) / (conv_spread * imax)) / 2.0 + 0.5


def keeps_values(iteration, conv_delay, conv_spread, imax, u):
    """Batched convergence gate: keep where keep_probability > u."""
    return keep_probability(iteration, conv_delay, conv_spread, imax) > u


def unused_penalty(usage, delta):
    """delta per palette entry never chosen by any pixel (SWASA.java:74-82).

    usage: (..., K) bool -> (...,) float32.
    """
    return delta * torch.sum(~usage, dim=-1).to(torch.float32)


Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _draw(generator: Generators, draw):
    """draw(g) from one generator, or stacked over a sequence of them."""
    if isinstance(generator, torch.Generator):
        return draw(generator)
    return torch.stack([draw(g) for g in generator])


def random_palettes(generator: Generators, pop: int, num_colors: int) -> torch.Tensor:
    """(pop, K, 3) uniform random initial palettes (SWASA.java:40-52);
    (B, pop, K, 3) from B generators."""
    return _draw(
        generator, lambda g: torch.rand((pop, num_colors, 3), generator=g, device=g.device)
    )


def draw_step(generator: Generators, pop: int, num_colors: int) -> dict:
    """One iteration's uniform draws: proposal noise U(-1,1) (pop, K, 3),
    acceptance and convergence draws U(0,1) (pop,); each with a leading
    image axis from B generators. Each generator draws in this order."""

    def uniform(*shape):
        return _draw(generator, lambda g: torch.rand(shape, generator=g, device=g.device))

    return {
        "prop": uniform(pop, num_colors, 3) * 2.0 - 1.0,
        "acc": uniform(pop),
        "conv": uniform(pop),
    }
