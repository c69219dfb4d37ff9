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
and "f32x3" run fp32.

On a CUDA tensor `fused_scielab_err_sums` launches the hand-written kernels
of `csrc/fused_fitness.cu` (built at first use, ops/_cuda.py) or raises; on
a CPU tensor it runs `fused_scielab_err_sums_reference`. The TPU layout
devices (128-multiple mirror padding, block-banded filter matrices with
R-folded edges, bf16 hi/lo scratch pairs, VMEM stripe budgets) are not
needed: the kernel reflects at the true borders by index. The column-slab
variant (`edges="slabs"`) serves column sharding across chips and waits for
the multi-GPU engine (ROADMAP A13).
"""

from __future__ import annotations

import torch

from .. import colorspace as cs
from ..config import DELTA_E_KINDS, PRECISIONS
from ..scielab.transform import SRC7
from . import _cuda
from .assign_kernel import bf16_round
from .conv import conv1d_symmetric

MAX_TAPS = 1025


def fused_scielab_err_sums_reference(
    q: torch.Tensor,
    target: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    whitepoint,
    deltaE: str = "CIE76",
    *,
    precision: str = "f32x3",
) -> torch.Tensor:
    """Plain torch version of the B2 kernel: (pop,) f32 Delta-E sums, or
    (B, pop) for a (B, pop, 3, H, W) bucket (each image run on its own).

    The filter is `scielab.transform.scielab_filter_stacked` written out,
    with bf16's rounding points between its steps."""
    if q.dim() == 5:
        return torch.stack([
            fused_scielab_err_sums_reference(qi, ti, kh, kv, whitepoint, deltaE, precision=precision)
            for qi, ti in zip(q, target)
        ])
    rnd = bf16_round if precision == "bf16" else (lambda t: t)
    t = conv1d_symmetric(rnd(q[:, list(SRC7)]), rnd(kh), axis=-1)  # horizontal pass
    y = conv1d_symmetric(rnd(t), rnd(kv), axis=-2)  # vertical pass
    filtered = y[:, 0:3] + y[:, 3:6]
    filtered[:, 0] += y[:, 6]
    lab = cs.opp_to_lab(torch.movedim(filtered, -3, -1), whitepoint)
    de = cs.DELTA_E_FNS[deltaE](torch.movedim(target, 0, -1), lab)
    return de.sum(dim=(1, 2))


def _check(q, target, kh, kv, deltaE, precision):
    if q.dim() not in (4, 5) or q.shape[-3] != 3:
        raise ValueError(f"q must be (pop, 3, H, W) or (B, pop, 3, H, W), got {tuple(q.shape)}")
    H, W = q.shape[-2:]
    want = (*q.shape[:-4], 3, H, W)
    if tuple(target.shape) != want:
        raise ValueError(f"target must be {want}, got {tuple(target.shape)}")
    if kh.shape != kv.shape or kh.dim() != 2 or kh.shape[0] != 7 or kh.shape[1] % 2 != 1:
        raise ValueError(f"filter stacks must be (7, odd taps), got {tuple(kh.shape)}, {tuple(kv.shape)}")
    half = kh.shape[1] // 2
    if half >= min(H, W):
        raise ValueError(f"filter half-width {half} must be below H={H} and W={W}")
    if deltaE not in DELTA_E_KINDS:
        raise ValueError(f"unknown deltaE kind {deltaE!r}; options: {list(DELTA_E_KINDS)}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; options: {list(PRECISIONS)}")
    for name, t in (("q", q), ("target", target), ("kh", kh), ("kv", kv)):
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
      precision: "highest" | "f32x3" (fp32) | "bf16" (module doc).
    """
    _check(q, target, kh, kv, deltaE, precision)
    if q.device.type == "cpu":
        return fused_scielab_err_sums_reference(
            q, target, kh, kv, whitepoint, deltaE, precision=precision
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    *lead, pop, _, H, W = q.shape
    members = pop * (lead[0] if lead else 1)
    taps = kh.shape[1]
    if taps > MAX_TAPS:
        raise ValueError(f"{taps} taps exceed the kernel's {MAX_TAPS}")
    q, target, kh, kv = (t.contiguous() for t in (q, target, kh, kv))
    wp = [float(v) for v in whitepoint]
    lib = _cuda.library()
    dev = q.device
    t7 = torch.empty((members, 7, H, W), dtype=torch.float32, device=dev)
    partials = torch.empty(
        (members, lib.hq_fused_num_partials(H, W)), dtype=torch.float32, device=dev
    )
    sums = torch.empty((*lead, pop), dtype=torch.float32, device=dev)
    fused_scielab_err_sums.launches += 1
    _cuda.check(
        lib.hq_fused_err_sums(
            q.data_ptr(), target.data_ptr(), kh.data_ptr(), kv.data_ptr(),
            taps, members, pop, H, W, wp[0], wp[1], wp[2], DELTA_E_KINDS.index(deltaE),
            int(precision == "bf16"), t7.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            _cuda.stream(dev),
        ),
        "hq_fused_err_sums",
    )
    return sums


#: launches of the CUDA kernels through this wrapper (not of the plain version)
fused_scielab_err_sums.launches = 0
