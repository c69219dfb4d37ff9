"""Row-sharded SWASA fitness, plain torch.

The counterpart of `hybridquantization_tpu/parallel/sharded.py`, the
engine's strategy "rows" (and its fallback where the column plan of
parallel.fast is infeasible):

  - each rank of a pixel line holds a strip of rows of every image of its
    data rank; every per-pixel stage (assignment, filtering, Delta-E) runs
    on the strip, and the vertical filter pass exchanges `half` halo rows
    with the neighbours (parallel.halo)
  - one all_gather per evaluation carries every member's Delta-E sum and
    usage counts across the line; each rank adds them up in rank order
    (population.line_totals), so the ranks of a line hold bit-identical
    fitness values, the TPU's psum pair
  - the annealing state is replicated over the pixel and pop ranks: each
    draws the same proposals from a generator seeded alike

A batch whose height is not a multiple of the pixel axis is padded with
mirrored rows (`row_plan`, `pad_rows`), masked out of the Delta-E mean by
`h_valid`. Assignment is B3 (ops.assign.nearest_palette, first index on
ties, fp32, as JAX's row path) and the filter is plain torch: the TPU ran
this path in XLA, with no Pallas kernel of its own.
"""

from __future__ import annotations

import torch

from .. import colorspace as cs
from ..config import QuantizationConfig
from ..ops.assign import nearest_palette, quantize_in_space
from ..ops.conv import conv1d_symmetric, conv1d_valid
from ..pipeline import _features
from ..scielab.filters import ScielabFilters
from ..scielab.transform import SRC7, stacked_kernels
from ..swasa import schedule
from .halo import exchange_row_halos
from .mesh import PIXEL_AXIS, POP_AXIS, Mesh, row_sharding
from .population import line_totals, pack, shard_population


def per_member(fn, palettes: torch.Tensor) -> torch.Tensor:
    """fn over a (..., K, 3) palette stack, one member at a time on the CPU
    and in one call on the card (ops.assign.per_image: torch's CPU pow rounds
    an element by its position in the tensor, so a member's numbers would
    depend on which members share its call, and a pop rank's slice would
    not be bit-equal to the whole population)."""
    if palettes.device.type != "cpu":
        return fn(palettes)
    flat = palettes.reshape(-1, *palettes.shape[-2:])
    return torch.stack([fn(p) for p in flat]).reshape(palettes.shape)


def scielab_filter_strip(
    opp_strip_chw: torch.Tensor, kh: torch.Tensor, kv: torch.Tensor, mesh: Mesh, axis: str = PIXEL_AXIS
) -> torch.Tensor:
    """S-CIELAB filtering of a (..., 3, Hs, W) row strip: the horizontal
    pass mirrored at the columns (rows are whole), then `half` halo rows
    from the neighbours (reflected at true image edges) and a valid-mode
    vertical pass."""
    t = conv1d_symmetric(opp_strip_chw[..., list(SRC7), :, :], kh, axis=-1)
    top, bottom = exchange_row_halos(t, kv.shape[1] // 2, mesh, axis)
    y = conv1d_valid(torch.cat([top, t, bottom], dim=-2), kv, axis=-2)
    out = y[..., 0:3, :, :] + y[..., 3:6, :, :]
    out[..., 0, :, :] += y[..., 6, :, :]
    return out


def strip_scielab(
    image_strip_hwc: torch.Tensor, kh, kv, whitepoint, mesh: Mesh, axis: str = PIXEL_AXIS
) -> torch.Tensor:
    """sRGB strip (..., Hs, W, 3) -> S-CIELAB strip (..., Hs, W, 3)."""
    opp = cs.xyz_to_opp(cs.srgb_to_xyz(image_strip_hwc))
    filtered = scielab_filter_strip(torch.movedim(opp, -1, -3), kh, kv, mesh, axis)
    return cs.opp_to_lab(torch.movedim(filtered, -3, -1), whitepoint)


def make_strip_fitness(
    image_strip_hwc: torch.Tensor,
    target_lab_strip: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    whitepoint,
    cfg: QuantizationConfig,
    mesh: Mesh,
    h_valid: int | None = None,
    axis: str = PIXEL_AXIS,
):
    """Fitness of palettes on one image's row strip; one collective
    combines the strips.

    Returns fitness(palettes (..., K, 3)) -> ((...) errors, (..., K) bool
    usage): pipeline.make_fitness's math per palette, the strips' Delta-E
    sums and usage counts gathered over `axis` and totalled in rank order.
    h_valid: the true image height when the batch was padded to the shard
    multiple (`pad_rows`); rows at or below it are masked out of the mean.
    """
    Hs, W, _ = image_strip_hwc.shape
    dev = image_strip_hwc.device
    de_fn = cs.DELTA_E_FNS[cfg.deltaE]
    assign_pixels = _features(image_strip_hwc.reshape(-1, 3), cfg, whitepoint).contiguous()
    row_ok, total = None, Hs * W * mesh.size(axis)
    if h_valid is not None:
        row_ok = (mesh.index(axis) * Hs + torch.arange(Hs, device=dev)) < h_valid
        total = h_valid * W

    def fitness(palettes: torch.Tensor):
        lead, K = palettes.shape[:-2], palettes.shape[-2]
        flat = palettes.reshape(-1, K, 3)
        feats = per_member(lambda p: _features(p, cfg, whitepoint), flat)
        idx = torch.stack([nearest_palette(assign_pixels, f) for f in feats]).long()  # (M, P)
        counts = torch.stack([torch.bincount(i, minlength=K) for i in idx])
        opp = torch.gather(per_member(cs.srgb_to_opp, flat), 1, idx[..., None].expand(-1, -1, 3))
        q_opp = opp.transpose(1, 2).reshape(-1, 3, Hs, W)
        filtered = scielab_filter_strip(q_opp, kh, kv, mesh, axis)
        de = de_fn(target_lab_strip, cs.opp_to_lab(torch.movedim(filtered, -3, -1), whitepoint))
        if row_ok is not None:
            de = torch.where(row_ok[:, None], de, 0.0)
        local = de.sum(dim=(-2, -1), dtype=torch.float64).float()
        err, counts = line_totals(mesh.all_gather(pack(local, counts), axis))
        usage = counts > 0
        err = err / total + schedule.unused_penalty(usage, cfg.swasa.delta)
        return err.reshape(lead), usage.reshape(*lead, K)

    return fitness


def row_plan(H: int, n: int, half: int) -> int:
    """Padded height for the row-sharded path (JAX's `_row_plan`): the
    smallest multiple of n whose strips are at least `half` rows, and, when
    padding is needed at all, at least `half` pad rows, so every valid
    row's vertical context comes from exact reflections. Raises when the
    mirrored pad would exceed the image."""
    H_pad = max(-(-H // n) * n, half * n)
    if H_pad > H:
        H_pad = max(H_pad, -(-(H + half) // n) * n)
    if H_pad - H > H:
        raise ValueError(
            f"height {H} too short to row-shard over {n} ranks: strips must be >= the filter "
            f"half-width {half} and the symmetric pad of {H_pad - H} rows exceeds the image; "
            "use a smaller pixel axis"
        )
    return H_pad


def pad_rows(images: torch.Tensor, H_pad: int) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H_pad, W, 3), the pad rows mirrored below the
    last row (row H + m repeats row H - 1 - m; needs H_pad - H <= H): they
    give the true bottom edge the reference's half-sample reflection context
    and add no palette usage."""
    H = images.shape[-3]
    if H_pad == H:
        return images
    rows = torch.cat([torch.arange(H), H - 1 - torch.arange(H_pad - H)]).to(images.device)
    return images.index_select(-3, rows)


def quantize_rows(images: torch.Tensor, palettes: torch.Tensor, cfg: QuantizationConfig, mesh: Mesh):
    """(b, H, W, 3) images, each through its (K, 3) palette: every pixel
    rank assigns its strip (B3), and an all_gather over the pixel line
    assembles the rows on every rank. The height is padded with repeats of
    the last row (the lookup is pointwise) and cropped."""
    n = mesh.size(PIXEL_AXIS)
    H = images.shape[1]
    H_pad = -(-H // n) * n
    if H_pad > H:
        images = torch.cat([images, images[:, -1:].expand(-1, H_pad - H, -1, -1)], dim=1)
    strips = images[:, row_sharding(mesh, H_pad)]
    out = quantize_in_space(
        strips.contiguous(), palettes, cfg.assignment_space, cs.WHITEPOINTS[cfg.scielab.whitepoint]
    )
    parts = mesh.all_gather(out, PIXEL_AXIS)  # (n, b, H_pad / n, W, 3)
    return torch.cat(list(parts), dim=1)[:, :H]


def build_sharded_fns(mesh: Mesh, cfg: QuantizationConfig, filters: ScielabFilters):
    """(prepare, quantize) of the row-sharded engine on this rank.

    prepare(images) takes this rank's (b, H, W, 3) images on the mesh's
    device and returns their population fitness ((b, pop, K, 3) -> ((b,
    pop), (b, pop, K))), the strips' targets built once; quantize(images,
    palettes) is `quantize_rows`. JAX's init and chunk are swasa.loop's
    init_state and run_chunk on that fitness: PyTorch runs eagerly, so no
    entry point needs building per mesh.
    """
    n_pop = mesh.size(POP_AXIS)
    if cfg.swasa.population % n_pop:
        raise ValueError(
            f"population {cfg.swasa.population} not divisible by the pop mesh axis ({n_pop})"
        )
    kh = stacked_kernels(filters, vertical=False, device=mesh.device)
    kv = stacked_kernels(filters, vertical=True, device=mesh.device)
    wp = tuple(float(v) for v in cs.WHITEPOINTS[cfg.scielab.whitepoint])
    half = filters.half_width

    def prepare(images: torch.Tensor):
        H = images.shape[1]
        H_pad = row_plan(H, mesh.size(PIXEL_AXIS), half)
        strips = pad_rows(images, H_pad)[:, row_sharding(mesh, H_pad)]
        targets = strip_scielab(strips, kh, kv, wp, mesh)
        h_valid = H if H_pad > H else None
        fits = [make_strip_fitness(s, t, kh, kv, wp, cfg, mesh, h_valid) for s, t in zip(strips, targets)]

        def fitness(palettes: torch.Tensor):
            errs, usage = zip(*(f(p) for f, p in zip(fits, palettes)))
            return torch.stack(errs), torch.stack(usage)

        return shard_population(fitness, cfg.swasa.population, n_pop, mesh)

    def quantize(images, palettes):
        return quantize_rows(images, palettes, cfg, mesh)

    return prepare, quantize
