"""Population-axis (EP-analog) sharding of the SWASA fitness.

The counterpart of `hybridquantization_tpu/parallel/population.py`: ranks
beyond the data x pixel grid each evaluate a slice of the candidate
palettes, and one collective recombines the (errors, usage) pair. The
annealing state stays replicated (proposals and acceptance are the same
arithmetic on every rank from the same generator), so that collective is
the only added communication: pop floats and pop x K counts per
evaluation. JAX recombines with a psum of zero-filled placements; here an
all_gather of the slices puts them in place. Both only move bits, so the
result is bit-equal to the population evaluated on one rank.
"""

from __future__ import annotations

import torch

from .mesh import POP_AXIS, Mesh


def pack(values: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(..., m) float32 values and (..., m, K) integer counts as one
    (..., m, 1 + K) int32 tensor (the floats' bits first), so one
    collective carries both."""
    bits = values.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([bits[..., None], counts.to(torch.int32)], dim=-1)


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of `pack`: ((..., m) float32, (..., m, K) int32)."""
    return packed[..., 0].contiguous().view(torch.float32), packed[..., 1:]


def shard_population(pop_fitness, pop: int, n_pop: int, mesh: Mesh, axis: str = POP_AXIS):
    """Wrap a population fitness ((..., pop, K, 3) -> ((..., pop), (..., pop,
    K) bool)) so each `axis` rank evaluates pop / n_pop members."""
    if n_pop == 1:
        return pop_fitness
    if pop % n_pop:
        raise ValueError(f"population {pop} not divisible by pop-axis size {n_pop}")
    local = pop // n_pop
    j = mesh.index(axis)

    def wrapped(palettes: torch.Tensor):
        errs, usage = pop_fitness(palettes[..., j * local : (j + 1) * local, :, :])
        parts = mesh.all_gather(pack(errs, usage), axis)  # (n_pop, ..., local, 1 + K)
        full = torch.cat(list(parts), dim=-2)
        errs, usage = unpack(full)
        return errs, usage > 0

    return wrapped


def rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """(n, ...) float32 parts gathered from the n ranks of a line, summed in
    float64 in rank order and rounded to float32 once. Every rank sums the
    same parts in the same order, so all of them hold the same bits,
    whatever order a backend's all_reduce would take, and a total does not
    depend on how its parts were grouped into collectives."""
    total = parts[0].double()
    for part in parts[1:]:
        total = total + part.double()
    return total.float()


def line_totals(parts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Totals of `pack`s gathered from the n ranks of a line, (n, ..., m,
    1 + K): the values by `rank_sum`, the counts exactly (int64)."""
    values, counts = unpack(parts)
    return rank_sum(values), counts.sum(0)
