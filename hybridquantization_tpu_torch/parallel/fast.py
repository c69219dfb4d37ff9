"""Column-sharded SWASA running the one-device kernels per shard.

The counterpart of `hybridquantization_tpu/parallel/fast.py`, the engine's
strategy "columns": the fitness of parallel.sharded distributes plain
torch, this one distributes the kernels of the one-device engine (B1 and
B2), so a mesh scales the fast formulation. Per fitness evaluation, per
shard of a pixel line:

  1. B1 on the shard's pixels (assignment is pixel-local: no collective);
  2. column guards: the `half` edge columns of the shard's opponent image to
     each neighbour (one batched send and receive per neighbour); a shard
     that holds a true image edge mirrors its own columns there, so
     reflection happens only at true edges, never at shard boundaries
     (SURVEY.md section 7 "hard parts"); rows are whole on every shard;
  3. B2s, B2 with the guards (ops.fused_fitness, `left_slab`/`right_slab`);
  4. one all_gather of every member's Delta-E sum and usage counts, totalled
     in rank order (population.line_totals): the whole per-evaluation
     pipeline of the reference (ImageManipulation.java:620-727) stays on
     the devices but for those few bytes.

At one pixel shard this is the one-device fitness (pipeline's
make_population_fitness: mirror B2, no collective).

The column plan (`plan_fast`) differs from JAX's on purpose: JAX pads the
width to a multiple of n_pixel x 128 columns and masks the pad, a layout of
the TPU's 128-column stripes. Here the n_pixel shards are contiguous column
ranges as equal as possible, with no padding and no mask; a plan whose
narrowest shard has fewer than `half` columns is infeasible (ROADMAP C).
"""

from __future__ import annotations

import torch

from .. import colorspace as cs
from ..config import DELTA_E_KINDS, QuantizationConfig
from ..ops.assign_kernel import assign_opp_usage_pop
from ..ops.fused_fitness import fused_scielab_err_sums
from ..pipeline import _features, _make_batch_context, make_population_fitness
from ..scielab.filters import ScielabFilters
from ..swasa import schedule
from .mesh import PIXEL_AXIS, POP_AXIS, Mesh
from .population import line_totals, pack, shard_population
from .sharded import per_member, quantize_rows


def plan_fast(H: int, W: int, half: int, n_pixel: int):
    """(cols, ok): the n_pixel shards' [lo, hi) column ranges, as equal as
    possible (the first W % n_pixel one column wider). ok is False when a
    shard has fewer than `half` columns (its guards and its neighbours'
    would not fit), when one shard holds all of W <= half (the mirror needs
    W > half), or when H <= half (the vertical mirror needs H > half)."""
    base, extra = divmod(W, n_pixel)
    edges = [0]
    for i in range(n_pixel):
        edges.append(edges[-1] + base + (i < extra))
    cols = tuple(zip(edges[:-1], edges[1:]))
    ok = base >= half and H > half and (n_pixel > 1 or W > half)
    return cols, ok


def supports_fast(cfg: QuantizationConfig) -> bool:
    """Whether the kernels serve this configuration: B2 computes the three
    Delta-E kinds; B1 and B2 take any K (palette tiles in shared memory),
    so JAX's second cause, K beyond the TPU kernel's VMEM budget, has no
    counterpart here."""
    return cfg.deltaE in DELTA_E_KINDS


def _column_guards(q: torch.Tensor, half: int, mesh: Mesh, axis: str = PIXEL_AXIS):
    """(left, right) guards of `half` columns for a (..., Ws) local block:
    the neighbours' edge columns, or this shard's own mirrored at a true
    image edge (guard column j of `left` stands for local column j - half,
    of `right` for local column Ws + j)."""
    n, i = mesh.size(axis), mesh.index(axis)
    # a shard's first columns lie right of the previous shard's last
    from_left, from_right = mesh.exchange(q[..., :half], q[..., -half:], axis)
    left = q[..., :half].flip(-1) if i == 0 else from_left
    right = q[..., -half:].flip(-1) if i == n - 1 else from_right
    return left, right


def make_fast_fitness(ctx: dict, cfg: QuantizationConfig, mesh: Mesh, *, H: int, W: int):
    """Population fitness of one shard's columns ((b, pop, K, 3), or (pop,
    K, 3) for one image) -> (([b,] pop) errors, ([b,] pop, K) usage).

    ctx: the shard's context (`shard_context`): "assign_pixels" ([b,] H *
    Ws, 3), "target_planar" ([b,] 3, H, Ws), "kh", "kv", "taps_on_host",
    "whitepoint".

    With cfg.overlap_collectives (the default) the population is evaluated
    member-pipelined: each member runs B1, its guard exchange and B2s, and
    starts the all_gather of its (sum, counts) before the next member's
    kernels, so the collective can fly while they run; the evaluation waits
    for all of them at the end. It is the counterpart of JAX's per-member
    psum (`fast.py:166-182`) and of the reference's cross-member event
    overlap (ImageManipulation.java:620-727). Its values are identical to
    the batched variant's (one B1 and one B2s launch and one all_gather for
    the population): the same per-member sums, totalled in the same order.
    """
    if mesh.size(PIXEL_AXIS) == 1:
        return make_population_fitness(ctx, cfg)
    wp = ctx["whitepoint"]
    half = ctx["kh"].shape[1] // 2
    Ws = ctx["target_planar"].shape[-1]
    conv = cfg.conv_precision or cfg.precision

    def local_pack(palettes: torch.Tensor) -> torch.Tensor:
        opp, counts = assign_opp_usage_pop(
            ctx["assign_pixels"],
            per_member(lambda p: _features(p, cfg, wp), palettes),
            per_member(cs.srgb_to_opp, palettes),
            precision=cfg.precision,
            tie_mode=cfg.tie_mode,
        )
        q = opp.reshape(*palettes.shape[:-2], 3, H, Ws)
        left, right = _column_guards(q, half, mesh)
        sums = fused_scielab_err_sums(
            q, ctx["target_planar"], ctx["kh"], ctx["kv"], wp, cfg.deltaE, precision=conv,
            left_slab=left, right_slab=right, taps_on_host=ctx["taps_on_host"],
        )
        return pack(sums, counts)

    def finish(parts: torch.Tensor):
        sums, counts = line_totals(parts)
        usage = counts > 0
        return sums / (H * W) + schedule.unused_penalty(usage, cfg.swasa.delta), usage

    def pop_fitness(palettes: torch.Tensor):
        return finish(mesh.all_gather(local_pack(palettes), PIXEL_AXIS))

    def pop_fitness_overlap(palettes: torch.Tensor):
        pending = [
            mesh.all_gather_async(local_pack(palettes[..., p : p + 1, :, :]), PIXEL_AXIS)
            for p in range(palettes.shape[-3])
        ]
        return finish(torch.cat([h.wait() for h in pending], dim=-2))

    return pop_fitness_overlap if cfg.overlap_collectives else pop_fitness


def shard_context(images: torch.Tensor, filters: ScielabFilters, cfg: QuantizationConfig, cols) -> dict:
    """The fitness context of columns [lo, hi) of (b, H, W, 3) images: the
    target S-CIELAB of the whole images (pipeline._make_batch_context),
    then the shard's columns of it and of the assignment features."""
    lo, hi = cols
    ctx = _make_batch_context(images, filters, cfg, images.device)
    b, H, W, _ = images.shape
    ctx["assign_pixels"] = ctx["assign_pixels"].reshape(b, H, W, 3)[:, :, lo:hi].reshape(b, -1, 3).contiguous()
    ctx["target_lab"] = ctx["target_lab"][:, :, lo:hi].contiguous()
    ctx["target_planar"] = ctx["target_planar"][..., lo:hi].contiguous()
    return ctx


def build_sharded_fast_fns(mesh: Mesh, cfg: QuantizationConfig, filters: ScielabFilters):
    """(prepare, quantize) of the column-sharded engine on this rank: the
    contract of parallel.sharded.build_sharded_fns, with the kernels'
    fitness per shard. prepare raises when the column plan is infeasible
    for the images' shape."""
    if not supports_fast(cfg):
        raise ValueError(
            f"deltaE {cfg.deltaE!r} not supported by the fused kernel (supported: "
            f"{sorted(DELTA_E_KINDS)}); use the row-sharded engine (parallel.sharded)"
        )
    n_pop, n_pixel = mesh.size(POP_AXIS), mesh.size(PIXEL_AXIS)
    if cfg.swasa.population % n_pop:
        raise ValueError(
            f"population {cfg.swasa.population} not divisible by the pop mesh axis ({n_pop})"
        )

    def prepare(images: torch.Tensor):
        _, H, W, _ = images.shape
        cols, ok = plan_fast(H, W, filters.half_width, n_pixel)
        if not ok:
            raise ValueError(infeasible(H, W, filters.half_width, n_pixel))
        ctx = shard_context(images, filters, cfg, cols[mesh.index(PIXEL_AXIS)])
        return shard_population(make_fast_fitness(ctx, cfg, mesh, H=H, W=W), cfg.swasa.population, n_pop, mesh)

    def quantize(images, palettes):
        return quantize_rows(images, palettes, cfg, mesh)

    return prepare, quantize


def infeasible(H: int, W: int, half: int, n_pixel: int) -> str:
    return (
        f"columns strategy infeasible for {H}x{W} over {n_pixel} shards: every shard needs at "
        f"least {half} columns (the filter half-width), and the image more than {half} rows"
    )
