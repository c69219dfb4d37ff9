"""The SWASA annealing loop.

The counterpart of `hybridquantization_tpu/swasa/loop.py`, with the same
iteration semantics as the reference loop (ImageManipulation.java:383-591):
ite = 1..imax, the temperature cooled before proposing, Metropolis acceptance
per member, best tracking, and population convergence that overwrites losing
members with the round's best *proposal* and its raw error (the reference's
quirk, ImageManipulation.java:538-545).

The loop stays on the device: a step reads nothing back to the host, and
`run_chunk` stacks the scalar telemetry of its iterations and copies it to
the host once per chunk, between which the caller reports progress and may
stop.

A state with a leading image axis (a bucket of B same-size images, each
with its own palettes and generator) anneals in lockstep: every step makes
one population-fitness call for the whole bucket, as the JAX batch engine's
vmapped `run_chunk` does (`parallel/fast.py:378-383`). The iteration, and
with it the temperature schedule, step width and convergence gate, is
shared; each image's draws come from its own generator, so an image's run
equals its single-image run from a generator seeded alike.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import SWASAConfig
from . import schedule
from .state import SWASAState

# population fitness: ([B,] pop, K, 3) -> (([B,] pop) errors, ([B,] pop, K) bool usage)
PopFitnessFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

TELEMETRY = ("best_error", "mean_error", "min_error", "std_error")


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i, ...] along the population axis (axis i.dim(): 0 for one
    image, 1 for a bucket), without a host round trip."""
    axis = i.dim()
    idx = i.reshape(*i.shape, *([1] * (x.dim() - axis)))
    idx = idx.expand(*i.shape, 1, *x.shape[axis + 1 :])
    return torch.gather(x, axis, idx).squeeze(axis)


def _device(generator) -> torch.device:
    return (generator if isinstance(generator, torch.Generator) else generator[0]).device


def init_state(
    generator, fitness: PopFitnessFn, cfg: SWASAConfig, init_colors=None
) -> SWASAState:
    """Initial palettes + fitness eval (ImageManipulation.java:413-493).

    generator: a torch.Generator, or a tuple of B for a bucket of images.
    init_colors: optional ([B,] pop, K, 3) starting palettes; defaults to
    the reference's uniform-random init (SWASA.java:40-52) drawn from
    `generator`.
    """
    dev = _device(generator)
    if init_colors is not None:
        colors = torch.as_tensor(init_colors, dtype=torch.float32, device=dev)
    else:
        colors = schedule.random_palettes(generator, cfg.population, cfg.num_colors)
    errors, _ = fitness(colors)
    best = torch.argmin(errors, dim=-1)
    return SWASAState(
        colors=colors,
        current_errors=errors,
        best_colors=_pick(colors, best),
        best_error=_pick(errors, best),
        temperature=torch.full(errors.shape[:-1], cfg.t0, dtype=torch.float32, device=dev),
        iteration=torch.tensor(0, dtype=torch.int32, device=dev),
        generator=generator,
    )


def make_step(fitness: PopFitnessFn, cfg: SWASAConfig):
    """One annealing iteration: `step(state, ite, draws=None) -> (state, telemetry)`.

    ite: () int32 tensor, the iteration number. draws: optional dict of the
    iteration's uniform draws {"prop": ([B,] pop, K, 3) U(-1,1), "acc":
    ([B,] pop), "conv": ([B,] pop)}; without it the step draws them from
    state.generator. telemetry: ([B,] 4) in TELEMETRY's order.
    """
    pop = cfg.population

    def step(state: SWASAState, ite: torch.Tensor, draws: dict | None = None):
        if draws is None:
            draws = schedule.draw_step(state.generator, pop, state.num_colors)
        # cool before evaluating (reduceTemperatureIfNecessary, :507)
        temperature = schedule.cool_temperature(state.temperature, ite, cfg.i_tc, cfg.alpha)
        proposals = schedule.propose(state.colors, ite, cfg.s0, cfg.beta, cfg.imax, draws["prop"])
        errors, _ = fitness(proposals)  # the penalty is already folded in

        accepted = schedule.accept(
            errors - state.current_errors, temperature[..., None], draws["acc"]
        )
        current_errors = torch.where(accepted, errors, state.current_errors)
        colors = torch.where(accepted[..., None, None], proposals, state.colors)

        # best tracking: sequential-scan-equivalent batched update
        cand = torch.where(accepted, errors, torch.full_like(errors, float("inf")))
        m = torch.argmin(cand, dim=-1)
        cand_m = _pick(cand, m)
        improved = cand_m < state.best_error
        best_error = torch.where(improved, cand_m, state.best_error)
        best_colors = torch.where(
            improved[..., None, None], _pick(proposals, m), state.best_colors
        )

        if cfg.convergence and pop > 1:
            min_idx = torch.argmin(errors, dim=-1)
            keep = schedule.keeps_values(
                ite, cfg.conv_delay, cfg.conv_spread, cfg.imax, draws["conv"]
            )
            colors = torch.where(
                keep[..., None, None], colors, _pick(proposals, min_idx)[..., None, :, :]
            )
            current_errors = torch.where(keep, current_errors, _pick(errors, min_idx)[..., None])

        new_state = SWASAState(
            colors=colors,
            current_errors=current_errors,
            best_colors=best_colors,
            best_error=best_error,
            temperature=temperature,
            iteration=ite,
            generator=state.generator,
        )
        telemetry = torch.stack(
            [
                best_error,
                errors.mean(dim=-1),
                errors.amin(dim=-1),
                errors.std(dim=-1, correction=0),
            ],
            dim=-1,
        )
        return new_state, telemetry

    return step


def run_chunk(state: SWASAState, fitness: PopFitnessFn, cfg: SWASAConfig, num_iters: int):
    """Run `num_iters` iterations after state.iteration.

    Returns (new_state, telemetry dict of (num_iters,) numpy arrays, or
    (num_iters, B) for a bucket), the telemetry copied to the host once.
    """
    step = make_step(fitness, cfg)
    ites = state.iteration + 1 + torch.arange(num_iters, dtype=torch.int32, device=state.iteration.device)
    rows = []
    for i in range(num_iters):
        state, t = step(state, ites[i])
        rows.append(t)
    tele = torch.stack(rows).cpu().numpy()
    return state, {k: np.ascontiguousarray(tele[..., j]) for j, k in enumerate(TELEMETRY)}
