"""Fused S-CIELAB Delta-E sums: the B2 kernel's wrapper and its plain version.

Replaces the TPU kernel `hybridquantization_tpu/ops/fused_fitness.py`
(`_fused_kernel`, launched by `fused_scielab_err_sums`): per population
member, the 7-component separable S-CIELAB filter of the quantized opponent
image (half-sample reflection at the true borders), Opp -> LAB, Delta-E
against the target S-CIELAB image (target first; CIE94 is asymmetric), summed
over the H x W pixels. The caller divides by H * W. An optional leading
image axis runs the members of a bucket of images in one launch (the JAX
batch engine vmaps the pallas_call, `parallel/fast.py:210`).

precision "bf16" is the TPU kernel's single-pass DEFAULT dots: the opponent
values and horizontal taps are rounded to bf16 for the horizontal pass, its
f32 output and the vertical taps for the vertical pass; products are exact
in f32 and accumulate in f32; the LAB and Delta-E tail is f32. "highest"
and "f32x3" run fp32: the engine's parity path pins fp32.

precision "split" is the TPU kernel's own f32x3 arithmetic, which a
QuantizationConfig does not select (`tools.tpu_f32x3` reaches it for fault
C2's emulation): every conv operand is split into bf16 hi = bf16(x) and lo
= bf16(x - hi), each product is hi.hi + hi.lo + lo.hi (lo.lo dropped,
`hybridquantization_tpu/ops/fused_fitness.py:369-393`, `:415-424`, the
matrices `:550-555`), and the horizontal pass's output is kept as its hi/lo
bf16 pair (the TPU's t7a/t7b scratches, `:388-392`, `:595-596`), which the
vertical pass multiplies the same way. The pairs are numerics, not layout:
they hold the intermediate to about 2^-16 relative, which is why the TPU
kernel's f32x3 is about 1e-5 relative (its doc, `:42-51`). The LAB and
Delta-E tail stays f32.

On a CUDA tensor `fused_scielab_err_sums` launches the hand-written kernels
of `csrc/fused_fitness.cu`, and in split mode up to MAX_FUSED_TAPS taps
those of `csrc/band_fitness.cu` (built at first use, ops/_cuda.py), or
raises; on a CPU tensor it runs `fused_scielab_err_sums_reference`. The TPU layout
devices (128-multiple mirror padding, block-banded filter matrices with
R-folded edges, VMEM stripe budgets) are not needed: the kernel reflects at
the true borders by index (an R-folded edge matrix multiplies the clamped
edge block by reversed taps, product by product, which is the same
function in every mode).

`fused_plan` picks the kernel path: up to MAX_FUSED_TAPS taps (the default
filter has 21) one fused kernel keeps the 7-channel intermediate in shared
memory; above that, where its ring of intermediate rows no longer fits an
SM's 227 KB, two kernels pass it through a (members, 7, H, W) device
scratch. Split mode up to MAX_FUSED_TAPS takes the "band" path instead:
`band_fitness.cu` runs both passes' three hi/lo products as wgmma band
products on the tensor cores (the band tiles from `band_tables`, the layout
from `band_plan`); above it, the two-pass kernels in split mode. Every path
ends in a fixed-order reduce kernel.

B2s, JAX's `edges="slabs"` variant, serves a column shard of a wider image
(parallel.fast): `left_slab` and `right_slab` are the (…, pop, 3, H, half)
columns just beyond the shard's two borders, half = taps // 2 (a
neighbour's edge columns, or the shard's own mirrored at a true image
border, parallel.fast._column_guards). The kernel reads them by index in its
horizontal pass; rows are whole, so the vertical pass mirrors as before.
JAX's 128-column slabs and valid-width mask (`hw`) are TPU layout devices:
the port's column plan has no padded columns to mask.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import colorspace as cs
from ..config import DELTA_E_KINDS, PRECISIONS
from ..metrics import span
from ..scielab.transform import SRC7
from . import _cuda
from .assign_kernel import bf16_round
from .conv import conv1d_symmetric, conv1d_valid, mirror_index

MAX_TAPS = 1025
#: B2's conv arithmetic: the config's precisions, and "split" (module doc)
CONV_PRECISIONS = PRECISIONS + ("split",)
#: the kernel's mode for each: 0 fp32, 1 bf16, 2 split (csrc/fused_fitness.cu Mode)
MODES = {"highest": 0, "f32x3": 0, "bf16": 1, "split": 2}
# The fused kernel's layout (csrc/fused_fitness.cu, whose kTileW, kTileH,
# kDefaultTaps, kMaxSmem, stage_width and ring_groups these mirror): 32-column
# strips, rows staged, filtered and output 32 at a time, a segment of up to
# ROWS_PER_BLOCK rows per block (faster than 32-row tiles on the H100,
# PERF.md); at DEFAULT_TAPS the coefficients travel as a kernel parameter
# (FMA operands), at other taps through shared memory.
TILE_W = TILE_H = 32
ROWS_PER_BLOCK = 512
DEFAULT_TAPS = 21  # scielab.filters.build_filters at 72 dpi, 45 cm
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
# the largest filter the fused kernel takes: its layout fits SMEM_LIMIT up
# to 97 taps, and up to there it beats the two-pass path, which takes the
# filters above (chip_smoke.py phase_b2_paths, PERF.md)
MAX_FUSED_TAPS = 97
# split mode's tensor-core kernel (csrc/band_fitness.cu, whose kTile, kChunk
# and layout() these mirror): 64-column strips (wgmma's M) walked in tiles of
# 64 output rows, products 32 rows wide, a segment of BAND_ROWS_PER_BLOCK
# rows per block; band_plan below
BAND_TILE = 64
BAND_CHUNK = 32
BAND_ROWS_PER_BLOCK = 256
# ... or shorter segments (multiples of 64), so that an image has at least
# this many blocks a member: a population of 4 then fills the card's 132 SMs
BAND_MIN_BLOCKS = 64
BAND_PIECE = 16  # f32 window rows staged at a time, two pieces in flight
BAND_TAIL = 8  # a tap's hi part under 2^-BAND_TAIL of its filter's largest is in the tail


def fused_smem_bytes(taps: int) -> int:
    """Shared memory of the fused kernel: two staging buffers of 32 rows x 3
    channels x (32 + 2 half, to a multiple of 4) columns, a ring of
    1 + ceil((taps - 1) / 32) groups of 32 rows x 7 channels x 32 columns,
    and, except at DEFAULT_TAPS, the two coefficient stacks, (taps, 8) each."""
    half = taps // 2
    stage_w = -(-(TILE_W + 2 * half) // 4) * 4
    ring_groups = 1 + (TILE_H + 2 * half - 1) // TILE_H
    coeffs = 0 if taps == DEFAULT_TAPS else 16 * taps
    return 4 * (2 * 3 * TILE_H * stage_w + ring_groups * TILE_H * 7 * TILE_W + coeffs)


def band_steps(taps: int) -> int:
    """Steps of 16 in a pass's contraction on the band path: the 64 outputs
    of a tile and their taps - 1 halo, rounded up."""
    return -(-(63 + taps) // 16)


def band_plan(H: int, W: int, taps: int, vtables: int = 1) -> dict:
    """Split mode's tensor-core path ("band", csrc/band_fitness.cu) for an H
    x W image: `rows_per_block` rows of a 64-column strip per block (at most
    BAND_ROWS_PER_BLOCK and the height rounded up to 64, and shorter down to
    64 while the image has fewer than BAND_MIN_BLOCKS blocks), walked in
    64-row tiles; `steps` steps of 16
    in each pass's contraction; `kp` = 16 steps staged columns a tile, `nh`
    staged rows (chunks of 32 covering the steps); `cores`, the core matrices
    of a horizontal and of a vertical band table (`band_tables`);
    `smem_bytes`: the staged window's bf16 hi and lo, the tables (the seven
    filters' horizontal ones and `vtables` vertical ones of their own, three
    parts each) and two pieces of BAND_PIECE f32 window rows; `partials`: the
    blocks of a member."""
    steps = band_steps(taps)
    kp, nh = 16 * steps, BAND_CHUNK * ((steps + 1) // 2)
    cores = (2 * steps + 7, 2 * steps - 1)
    strips = -(-W // BAND_TILE)
    rows = min(BAND_ROWS_PER_BLOCK, -(-H // BAND_TILE) * BAND_TILE)
    while rows > BAND_TILE and strips * -(-H // rows) < BAND_MIN_BLOCKS:
        rows -= BAND_TILE
    return {"path": "band", "rows_per_block": rows, "steps": steps, "kp": kp, "nh": nh, "cores": cores,
            "smem_bytes": 4 * kp * nh + 3 * 128 * (7 * cores[0] + vtables * cores[1]) + 2 * 4 * BAND_PIECE * (kp + 4),
            "partials": strips * -(-H // rows)}


def fused_plan(H: int, W: int, taps: int, split: bool = False, vtables: int = 1) -> dict:
    """The B2 kernel path for an H x W image and `taps` taps: "fused" (one
    kernel, `rows_per_block` rows of a 32-column strip per block, at most the
    image's height rounded up to 32) or, above MAX_FUSED_TAPS, "two_pass"
    (an (members, 7, H, W) scratch, 256 columns of a row per block);
    `smem_bytes`: a block's dynamic shared memory; `partials`: the blocks,
    and the partial sums, of each member. With `split` (precision "split")
    the path up to MAX_FUSED_TAPS is `band_plan`'s (with `vtables` vertical
    band tables of their own) instead of "fused", where its shared memory
    fits a block. The kernel library launches what the plan says."""
    if taps <= MAX_FUSED_TAPS and split:
        plan = band_plan(H, W, taps, vtables)
        if plan["smem_bytes"] <= SMEM_LIMIT:
            return plan
        return {"path": "two_pass", "rows_per_block": 0, "smem_bytes": 7 * taps * 4, "partials": -(-W // 256) * H}
    if taps <= MAX_FUSED_TAPS:
        rows = min(ROWS_PER_BLOCK, -(-H // TILE_H) * TILE_H)
        return {"path": "fused", "rows_per_block": rows, "smem_bytes": fused_smem_bytes(taps),
                "partials": -(-W // TILE_W) * -(-H // rows)}
    return {"path": "two_pass", "rows_per_block": 0, "smem_bytes": 7 * taps * 4,
            "partials": -(-W // 256) * H}


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) f32 tensors of x's bf16 split: hi = bf16(x), lo = bf16(x - hi),
    both rounded to nearest even (the TPU kernel's `_split_bf16`)."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def band_parts(k: torch.Tensor) -> torch.Tensor:
    """(F, 3, taps) f32: the (F, taps) stack's taps split as split mode's
    tensor-core kernel multiplies them: the core of the hi part (`split_bf16`),
    its tail (the hi parts under 2^-BAND_TAIL of the filter's largest; their
    sum is the hi part) and the lo part."""
    hi, lo = split_bf16(k.to(torch.float32))
    core = hi.abs() >= hi.abs().amax(-1, keepdim=True) * 2.0 ** -BAND_TAIL
    zero = torch.zeros((), device=k.device)
    return torch.stack([torch.where(core, hi, zero), torch.where(core, zero, hi), lo], 1)


def band_cores(k: torch.Tensor, n: int, top: int) -> torch.Tensor:
    """(F, 3, n, 8, 8) bf16: the (F, taps) stack's `band_parts`, as n 8 x 8
    core matrices of their band, C[f, part, e, i, j] = part[f, 8 (top - e) +
    j - i] (0 outside the taps): row i, column j of the band's block on its
    diagonal top - e (csrc/band_fitness.cu reads them through wgmma
    descriptors)."""
    taps, dev = k.shape[1], k.device
    j = torch.arange(8, device=dev)
    idx = 8 * (top - torch.arange(n, device=dev)).view(n, 1, 1) + j.view(1, 1, 8) - j.view(1, 8, 1)
    vals = band_parts(k)[..., idx.clamp(0, taps - 1)]
    return torch.where((idx >= 0) & (idx < taps), vals, torch.zeros((), device=dev)).to(torch.bfloat16)


class BandTables(NamedTuple):
    """Split mode's band tables (`band_tables`) as the kernel takes them."""
    cores: torch.Tensor  # (3 (7 hcores + vtables vcores), 8, 8) bf16
    vmap: object  # 15 C ints: each filter's vertical base, its part stride, the tails mask
    vtables: int


def band_tables(kh: torch.Tensor, kv: torch.Tensor) -> BandTables:
    """The band tiles of split mode's tensor-core kernel, on the stacks'
    device (steps = `band_steps`): the seven filters' horizontal tables
    (`band_cores` of kh, 2 steps + 7 core matrices from diagonal 2 steps - 1
    down: every block of the band T[m][k] = kh[k - m] that a tile's 64 x 16
    steps reach), then a vertical table (2 steps - 1 from diagonal 2 steps -
    5: the blocks of V[k][n] = kv[k - n] that a chunk of 32 output rows
    reaches) for each filter whose vertical taps are not its horizontal
    ones; the others read entries 4 on of their horizontal table. vmap: per
    filter the core matrix where its vertical table starts and the stride
    of its parts, then the mask of filters with a tail (bit f: horizontal,
    bit 7 + f: vertical)."""
    steps = band_steps(kh.shape[1])
    hcores, vcores = 2 * steps + 7, 2 * steps - 1
    own = [f for f in range(7) if not torch.equal(kh[f], kv[f])]
    base = [own.index(f) * 3 * vcores + 21 * hcores if f in own else 3 * f * hcores + 4 for f in range(7)]
    stride = [vcores if f in own else hcores for f in range(7)]
    tails = 0
    for bit, k in ((0, kh), (7, kv)):
        tails |= sum(1 << (bit + f) for f in range(7) if bool((band_parts(k[f:f + 1])[0, 1] != 0).any()))
    cores = [band_cores(kh, hcores, 2 * steps - 1).flatten(0, 2)]
    if own:
        cores.append(band_cores(kv[own], vcores, 2 * steps - 5).flatten(0, 2))
    return BandTables(torch.cat(cores).contiguous(), (ctypes.c_int * 15)(*base, *stride, tails), len(own))


#: the last few pairs of stacks split mode ran with, and their band tables:
#: (kh, kv, their version counters, tables); the stacks are held, so that
#: another tensor cannot take their place
_BAND_TABLES: list = []


def cached_band_tables(kh: torch.Tensor, kv: torch.Tensor) -> BandTables:
    """`band_tables(kh, kv)`, made once per pair of stacks (the same tensor
    objects, not changed in place since), so that a launch of split mode's
    tensor-core kernel builds no table on the device."""
    versions = (kh._version, kv._version)
    for h, v, seen, tables in _BAND_TABLES:
        if h is kh and v is kv and seen == versions:
            return tables
    tables = band_tables(kh.detach(), kv.detach())
    _BAND_TABLES.insert(0, (kh, kv, versions, tables))
    del _BAND_TABLES[4:]
    return tables


def kernel_taps(kh: torch.Tensor, kv: torch.Tensor):
    """The default filter's coefficients as the fused kernel takes them: kh
    then kv (2 x 7 x 21 floats) on the host, as ctypes arrays by kernel mode
    (MODES): 0 fp32, 1 rounded to bf16 (so [False] and [True] pick fp32 and
    bf16); None for another number of taps. Made once where the stacks are
    made (pipeline._make_context), so that a launch copies nothing from the
    device."""
    if kh.shape[-1] != DEFAULT_TAPS:
        return None
    stacks = torch.stack([kh, kv]).detach().to("cpu", torch.float32)
    return {mode: (ctypes.c_float * t.numel())(*t.flatten().tolist())
            for mode, t in ((0, stacks), (1, bf16_round(stacks)))}


def _conv_pass(x: torch.Tensor, k: torch.Tensor, axis: int, precision: str, mirrored: bool) -> torch.Tensor:
    """One pass of the filter along `axis`, mirrored at both ends or in valid
    mode over guard columns, in B2's arithmetic: f32; bf16 operands; or
    "split": each tap, in ascending order, adds th.xh, then th.xl, then
    tl.xh to one f32 accumulator (the TPU kernel's three dots, lo.lo
    dropped). The split's products are exact in f32, so each step rounds as
    the CUDA kernel's fmaf does, in the kernel's order."""
    if precision != "split":
        if precision == "bf16":
            x, k = bf16_round(x), bf16_round(k)
        return (conv1d_symmetric if mirrored else conv1d_valid)(x, k, axis=axis)
    C, taps = k.shape
    if mirrored:
        x = x.index_select(axis, mirror_index(x.shape[axis], taps // 2, x.device))
    (xh, xl), (th, tl) = split_bf16(x), split_bf16(k.to(x.device, x.dtype).view(C, taps, 1, 1))
    n = x.shape[axis] - taps + 1
    out = torch.zeros_like(xh.narrow(axis, 0, n))
    for t in range(taps):
        h = xh.narrow(axis, t, n)
        out += th[:, t] * h
        out += th[:, t] * xl.narrow(axis, t, n)
        out += tl[:, t] * h
    return out


def fused_scielab_err_sums_reference(
    q: torch.Tensor,
    target: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    whitepoint,
    deltaE: str = "CIE76",
    *,
    precision: str = "f32x3",
    left_slab: torch.Tensor | None = None,
    right_slab: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of the B2 kernel: (pop,) f32 Delta-E sums, or
    (B, pop) for a (B, pop, 3, H, W) bucket (each image run on its own).

    The filter is `scielab.transform.scielab_filter_stacked` written out,
    with bf16's rounding points between its steps, or in "split" mode the
    split products of each pass (`_conv_pass`; the horizontal output enters
    the vertical pass as its hi/lo pair). With the column guards (B2s) the
    horizontal pass runs in valid mode over [left | q | right]."""
    if q.dim() == 5:
        guards = zip(left_slab, right_slab) if left_slab is not None else [(None, None)] * len(q)
        return torch.stack([
            fused_scielab_err_sums_reference(
                qi, ti, kh, kv, whitepoint, deltaE, precision=precision, left_slab=li, right_slab=ri
            )
            for qi, ti, (li, ri) in zip(q, target, guards)
        ])
    return delta_e_reference(q, target, kh, kv, whitepoint, deltaE, precision=precision,
                             left_slab=left_slab, right_slab=right_slab).sum(dim=(1, 2))


def delta_e_reference(q, target, kh, kv, whitepoint, deltaE="CIE76", *, precision="f32x3",
                      left_slab=None, right_slab=None) -> torch.Tensor:
    """The plain version's (pop, H, W) per-pixel Delta-E of one image, before
    the sum (`fused_scielab_err_sums_reference`'s arguments, q 4-D)."""
    if left_slab is None:
        t = _conv_pass(q[:, list(SRC7)], kh, -1, precision, mirrored=True)  # horizontal pass
    else:
        x = torch.cat([left_slab, q, right_slab], -1)[:, list(SRC7)]
        t = _conv_pass(x, kh, -1, precision, mirrored=False)
    y = _conv_pass(t, kv, -2, precision, mirrored=True)  # vertical pass
    filtered = y[:, 0:3] + y[:, 3:6]
    filtered[:, 0] += y[:, 6]
    lab = cs.opp_to_lab(torch.movedim(filtered, -3, -1), whitepoint)
    return cs.DELTA_E_FNS[deltaE](torch.movedim(target, 0, -1), lab)


def _check(q, target, kh, kv, deltaE, precision, left_slab, right_slab):
    if q.dim() not in (4, 5) or q.shape[-3] != 3:
        raise ValueError(f"q must be (pop, 3, H, W) or (B, pop, 3, H, W), got {tuple(q.shape)}")
    H, W = q.shape[-2:]
    want = (*q.shape[:-4], 3, H, W)
    if tuple(target.shape) != want:
        raise ValueError(f"target must be {want}, got {tuple(target.shape)}")
    if kh.shape != kv.shape or kh.dim() != 2 or kh.shape[0] != 7 or kh.shape[1] % 2 != 1:
        raise ValueError(f"filter stacks must be (7, odd taps), got {tuple(kh.shape)}, {tuple(kv.shape)}")
    half = kh.shape[1] // 2
    if (left_slab is None) != (right_slab is None):
        raise ValueError("left_slab and right_slab go together")
    guards = ()
    if left_slab is not None:
        want_g = (*q.shape[:-1], half)
        for name, g in (("left_slab", left_slab), ("right_slab", right_slab)):
            if tuple(g.shape) != want_g:
                raise ValueError(f"{name} must be {want_g}, got {tuple(g.shape)}")
        guards = (("left_slab", left_slab), ("right_slab", right_slab))
    if half >= H or (left_slab is None and half >= W):
        raise ValueError(f"filter half-width {half} must be below H={H} and W={W} (W only without guards)")
    if deltaE not in DELTA_E_KINDS:
        raise ValueError(f"unknown deltaE kind {deltaE!r}; options: {list(DELTA_E_KINDS)}")
    if precision not in CONV_PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; options: {list(CONV_PRECISIONS)}")
    for name, t in (("q", q), ("target", target), ("kh", kh), ("kv", kv), *guards):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def fused_scielab_err_sums(
    q: torch.Tensor,
    target: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    whitepoint,
    deltaE: str = "CIE76",
    *,
    precision: str = "f32x3",
    left_slab: torch.Tensor | None = None,
    right_slab: torch.Tensor | None = None,
    taps_on_host=None,
) -> torch.Tensor:
    """(pop,) f32 S-CIELAB Delta-E sums over H x W, or (B, pop) for a bucket.

    Args:
      q: (pop, 3, H, W) f32 quantized opponent images, or (B, pop, 3, H, W).
      target: (3, H, W) f32 planar target S-CIELAB (LAB) image, or
        (B, 3, H, W), one per image.
      kh, kv: (7, taps) f32 horizontal / vertical filter stacks
        (scielab.transform.stacked_kernels).
      whitepoint: 3 floats.
      deltaE: "CIE76", "CIE94" or "CIEDE2000".
      precision: "highest" | "f32x3" (fp32) | "bf16" | "split" (the TPU's
        f32x3; module doc).
      left_slab, right_slab: B2s's column guards, both or neither (module
        doc), each shaped like q with taps // 2 columns; without them the
        horizontal pass mirrors at both column borders.
      taps_on_host: `kernel_taps(kh, kv)`, made once for the stacks; without
        it a fused launch at the default 21 taps copies them from the device.
        Split mode's tensor-core kernel takes `cached_band_tables(kh, kv)`.

    Split mode runs on the tensor cores (`band_plan`, csrc/band_fitness.cu)
    up to MAX_FUSED_TAPS taps and in the two-pass kernels above; every
    CUDA launch takes one of the hand-written kernels, or raises.
    """
    with span("b2"):
        _check(q, target, kh, kv, deltaE, precision, left_slab, right_slab)
        if q.device.type == "cpu":
            return fused_scielab_err_sums_reference(
                q, target, kh, kv, whitepoint, deltaE, precision=precision,
                left_slab=left_slab, right_slab=right_slab,
            )
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        *lead, pop, _, H, W = q.shape
        members = pop * (lead[0] if lead else 1)
        taps = kh.shape[1]
        if taps > MAX_TAPS:
            raise ValueError(f"{taps} taps exceed the kernel's {MAX_TAPS}")
        q, target, kh, kv = (t.contiguous() for t in (q, target, kh, kv))
        slabs = left_slab is not None
        if slabs:
            left_slab, right_slab = left_slab.contiguous(), right_slab.contiguous()
        wp = [float(v) for v in whitepoint]
        mode = MODES[precision]
        bands = cached_band_tables(kh, kv) if mode == MODES["split"] and taps <= MAX_FUSED_TAPS else None
        plan = fused_plan(H, W, taps, split=mode == MODES["split"], vtables=bands.vtables if bands else 1)
        path = plan["path"]
        lib = _cuda.library()
        dev = q.device
        partials = torch.empty((members, plan["partials"]), dtype=torch.float32, device=dev)
        sums = torch.empty((*lead, pop), dtype=torch.float32, device=dev)
        guards = (left_slab.data_ptr(), right_slab.data_ptr()) if slabs else (None, None)
        fused_scielab_err_sums.launches += 1
        fused_scielab_err_sums.slab_launches += slabs
        fused_scielab_err_sums.two_pass_launches += path == "two_pass"
        fused_scielab_err_sums.split_launches += mode == MODES["split"]
        fused_scielab_err_sums.band_launches += path == "band"
        if path == "band":
            _cuda.check(
                lib.hq_band_err_sums(
                    q.data_ptr(), *guards, target.data_ptr(), bands.cores.data_ptr(),
                    ctypes.addressof(bands.vmap), bands.vtables,
                    taps, members, pop, H, W, wp[0], wp[1], wp[2], DELTA_E_KINDS.index(deltaE),
                    plan["rows_per_block"], plan["smem_bytes"], plan["partials"], partials.data_ptr(),
                    sums.data_ptr(), _cuda.stream(dev),
                ),
                "hq_band_err_sums",
            )
            return sums
        fused = path == "fused"
        param = None
        if fused and taps == DEFAULT_TAPS:
            param = (taps_on_host or kernel_taps(kh, kv))[mode]
        # the two-pass path's intermediate; the fused kernel keeps it on the SM
        t7 = None if fused else torch.empty((members, 7, H, W), dtype=torch.float32, device=dev)
        _cuda.check(
            lib.hq_fused_err_sums(
                q.data_ptr(), *guards, target.data_ptr(), kh.data_ptr(), kv.data_ptr(),
                ctypes.addressof(param) if param is not None else None, taps, members, pop, H, W,
                wp[0], wp[1], wp[2], DELTA_E_KINDS.index(deltaE), mode, plan["rows_per_block"],
                plan["smem_bytes"], plan["partials"], t7.data_ptr() if t7 is not None else None,
                partials.data_ptr(), sums.data_ptr(), _cuda.stream(dev),
            ),
            "hq_fused_err_sums",
        )
        return sums


#: launches of the CUDA kernels through this wrapper (not of the plain version)
fused_scielab_err_sums.launches = 0
#: of those, the launches with column guards (B2s)
fused_scielab_err_sums.slab_launches = 0
#: of those, the launches of the two-pass path (taps above MAX_FUSED_TAPS)
fused_scielab_err_sums.two_pass_launches = 0
#: of those, the launches in split mode (the TPU's f32x3)
fused_scielab_err_sums.split_launches = 0
#: of those, the launches of split mode's tensor-core kernel (csrc/band_fitness.cu)
fused_scielab_err_sums.band_launches = 0
