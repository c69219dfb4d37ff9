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
of `csrc/fused_fitness.cu` (built at first use, ops/_cuda.py) or raises; on
a CPU tensor it runs `fused_scielab_err_sums_reference`. The TPU layout
devices (128-multiple mirror padding, block-banded filter matrices with
R-folded edges, VMEM stripe budgets) are not needed: the kernel reflects at
the true borders by index (an R-folded edge matrix multiplies the clamped
edge block by reversed taps, product by product, which is the same
function in every mode).

`fused_plan` picks the kernel path: up to MAX_FUSED_TAPS taps (the default
filter has 21) one fused kernel keeps the 7-channel intermediate in shared
memory; above that, where its ring of intermediate rows no longer fits an
SM's 227 KB, two kernels pass it through a (members, 7, H, W) device
scratch. Either way a fixed-order reduce kernel follows.

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

import torch

from .. import colorspace as cs
from ..config import DELTA_E_KINDS, PRECISIONS
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


def fused_plan(H: int, W: int, taps: int) -> dict:
    """The B2 kernel path for an H x W image and `taps` taps: "fused" (one
    kernel, `rows_per_block` rows of a 32-column strip per block, at most the
    image's height rounded up to 32) or, above MAX_FUSED_TAPS, "two_pass"
    (an (members, 7, H, W) scratch, 256 columns of a row per block);
    `smem_bytes`: a block's dynamic shared memory; `partials`: the blocks,
    and the partial sums, of each member. The kernel library launches what
    the plan says."""
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


def kernel_taps(kh: torch.Tensor, kv: torch.Tensor):
    """The default filter's coefficients as the fused kernel takes them: kh
    then kv (2 x 7 x 21 floats) on the host, as ctypes arrays by kernel mode
    (MODES): 0 fp32, 1 rounded to bf16 (so [False] and [True] pick fp32 and
    bf16), 2 the split's hi stacks then its lo stacks; None for another
    number of taps. Made once where the stacks are made
    (pipeline._make_context), so that a launch copies nothing from the
    device."""
    if kh.shape[-1] != DEFAULT_TAPS:
        return None
    stacks = torch.stack([kh, kv]).detach().to("cpu", torch.float32)
    floats = {0: stacks, 1: bf16_round(stacks), 2: torch.cat(split_bf16(stacks))}
    return {mode: (ctypes.c_float * t.numel())(*t.flatten().tolist()) for mode, t in floats.items()}


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
        it a CUDA launch at the default 21 taps copies them from the device.
    """
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
    plan = fused_plan(H, W, taps)
    fused = plan["path"] == "fused"
    param = None
    if fused and taps == DEFAULT_TAPS:
        param = (taps_on_host or kernel_taps(kh, kv))[mode]
    lib = _cuda.library()
    dev = q.device
    # the two-pass path's intermediate; the fused kernel keeps it on the SM
    t7 = None if fused else torch.empty((members, 7, H, W), dtype=torch.float32, device=dev)
    partials = torch.empty((members, plan["partials"]), dtype=torch.float32, device=dev)
    sums = torch.empty((*lead, pop), dtype=torch.float32, device=dev)
    fused_scielab_err_sums.launches += 1
    fused_scielab_err_sums.slab_launches += slabs
    fused_scielab_err_sums.two_pass_launches += not fused
    fused_scielab_err_sums.split_launches += mode == MODES["split"]
    _cuda.check(
        lib.hq_fused_err_sums(
            q.data_ptr(), left_slab.data_ptr() if slabs else None,
            right_slab.data_ptr() if slabs else None, target.data_ptr(), kh.data_ptr(), kv.data_ptr(),
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
