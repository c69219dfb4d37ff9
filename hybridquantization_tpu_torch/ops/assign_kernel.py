"""Nearest-palette assignment kernels: B1 and B3, their wrappers and their
plain versions.

B1 replaces the TPU kernel `hybridquantization_tpu/ops/pallas_assign.py`
(`_assign_opp_pop_kernel`, launched by `assign_opp_pop`). For every member
of a population of palettes and every pixel: the nearest palette entry by
score f . c_k - |c_k|^2 / 2 (first index on ties, NaN never wins), the
winner's opponent color, and exact int32 per-entry pixel counts. Usage
flags are `counts > 0`.

B3 replaces `_assign_idx_kernel` of the same file (launched by
`assign_idx`): the int32 nearest index per pixel for one palette, with the
same score and tie rule, and nothing else. Every one-palette lookup of
the engine runs it: the exact Lloyd polish (ops.assign.lloyd_step, once
per step), the histogram Lloyd steps of the k-means seeding and polish
(ops.kmeans) and quantize (ops.assign.nearest_palette).

On a CUDA tensor `assign_opp_usage_pop` and `assign_idx` launch the
hand-written kernels in `csrc/assign_pop.cu` and `csrc/assign_idx.cu`
(built at first use, ops/_cuda.py) or raise; on a CPU tensor they run
their `*_reference` versions. The TPU layout devices (pick_block, x4/c4
packing with a bias row, lane folds, padded pixels) are not needed: the
kernels tile K through shared memory and take the true P.

One deliberate difference from the Pallas kernels: there a NaN score makes
the pixel's max NaN, so no entry of that palette wins (B3 then writes
K_pad, which segment_sum drops). Here a NaN score never wins, the other
entries compete as usual, and a pixel whose scores are all NaN gets -1.
"""

from __future__ import annotations

import torch

from . import _cuda

DEFAULT_BLOCK = 1 << 16


def scores(pixels: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(P, K) fp32 scores p . c_k - |c_k|^2 / 2 whose argmax is the nearest entry.

    The contraction is written out over the 3 features, so no matmul
    precision mode (TF32 on the GPU) can round it. A NaN score becomes
    -inf, so it never wins, as the kernels' strict scan skips it.
    """
    s = -0.5 * torch.sum(palette * palette, dim=-1)
    for f in range(pixels.shape[-1]):
        s = s + pixels[:, f : f + 1] * palette[:, f]
    return torch.nan_to_num(s, nan=float("-inf"))


def assign_opp_usage_pop_reference(
    features: torch.Tensor,
    pal_feats: torch.Tensor,
    opp_palettes: torch.Tensor,
    *,
    block_size: int = DEFAULT_BLOCK,
):
    """Plain torch version of the B1 kernel: (opp (pop, 3, P) f32,
    counts (pop, K) int32, idx (pop, P) int32)."""
    pop, K, _ = pal_feats.shape
    P = features.shape[0]
    idx = torch.stack(
        [assign_idx_reference(features, pal_feats[p], block_size=block_size) for p in range(pop)]
    ).long()
    won = idx >= 0
    opp = torch.gather(opp_palettes, 1, idx.clamp_min(0)[:, :, None].expand(pop, P, 3))
    opp = torch.where(won[:, :, None], opp, 0.0)
    counts = torch.stack([torch.bincount(i[i >= 0], minlength=K) for i in idx])
    return opp.transpose(1, 2).contiguous(), counts.to(torch.int32), idx.to(torch.int32)


def _check(features, pal_feats, opp_palettes):
    if features.dim() != 2 or features.shape[1] != 3:
        raise ValueError(f"features must be (P, 3), got {tuple(features.shape)}")
    if pal_feats.dim() != 3 or pal_feats.shape[2] != 3:
        raise ValueError(f"pal_feats must be (pop, K, 3), got {tuple(pal_feats.shape)}")
    if opp_palettes.shape != pal_feats.shape:
        raise ValueError(
            f"opp_palettes {tuple(opp_palettes.shape)} != pal_feats {tuple(pal_feats.shape)}"
        )
    for name, t in (("features", features), ("pal_feats", pal_feats), ("opp_palettes", opp_palettes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"{name} is on {t.device}, features on {features.device}")


def assign_opp_usage_pop(
    features: torch.Tensor,
    pal_feats: torch.Tensor,
    opp_palettes: torch.Tensor,
    *,
    return_index: bool = False,
):
    """Population-fused assignment.

    Args:
      features: (P, 3) f32 pixel features shared by all members (sRGB or LAB).
      pal_feats: (pop, K, 3) f32 candidate palettes in the feature space.
      opp_palettes: (pop, K, 3) f32 candidate palettes in opponent space.
      return_index: also return the (pop, P) int32 winner indices.

    Returns:
      (opp (pop, 3, P) f32, counts (pop, K) int32[, idx (pop, P) int32]).
      A pixel whose scores are all NaN has no winner: opp 0, index -1, no count.
    """
    _check(features, pal_feats, opp_palettes)
    if features.device.type == "cpu":
        opp, counts, idx = assign_opp_usage_pop_reference(features, pal_feats, opp_palettes)
        return (opp, counts, idx) if return_index else (opp, counts)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    pop, K, _ = pal_feats.shape
    P = features.shape[0]
    features = features.contiguous()
    pal_feats = pal_feats.contiguous()
    opp_palettes = opp_palettes.contiguous()
    opp = torch.empty((pop, 3, P), dtype=torch.float32, device=features.device)
    counts = torch.zeros((pop, K), dtype=torch.int32, device=features.device)
    idx = (
        torch.empty((pop, P), dtype=torch.int32, device=features.device)
        if return_index
        else None
    )
    lib = _cuda.library()
    assign_opp_usage_pop.launches += 1
    _cuda.check(
        lib.hq_assign_pop(
            features.data_ptr(),
            pal_feats.data_ptr(),
            opp_palettes.data_ptr(),
            P,
            K,
            pop,
            opp.data_ptr(),
            counts.data_ptr(),
            idx.data_ptr() if idx is not None else None,
            _cuda.stream(features.device),
        ),
        "hq_assign_pop",
    )
    return (opp, counts, idx) if return_index else (opp, counts)


#: launches of the CUDA kernel through this wrapper (not of the plain version)
assign_opp_usage_pop.launches = 0


def assign_idx_reference(
    features: torch.Tensor, palette: torch.Tensor, *, block_size: int = DEFAULT_BLOCK
) -> torch.Tensor:
    """Plain torch version of the B3 kernel: (P,) int32 nearest index, first
    index on ties, -1 where every score is NaN.

    The port's one plain nearest-entry scan (B1's plain version runs it per
    member). It works on blocks of pixels, so the (block, K) score tile
    stays bounded: a 4K frame at K=256 would need 8.5 GB unblocked.
    """
    idx = torch.empty(features.shape[0], dtype=torch.int32, device=features.device)
    for lo in range(0, features.shape[0], block_size):
        block = features[lo : lo + block_size]
        best, arg = torch.max(scores(block, palette), dim=-1)
        # all scores NaN (now -inf): no winner, like the kernels' strict scan
        idx[lo : lo + block.shape[0]] = torch.where(best > float("-inf"), arg, -1).to(torch.int32)
    return idx


def assign_idx(features: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Nearest-palette index of every pixel (the B3 kernel).

    Args:
      features: (P, 3) f32 pixel features (sRGB or LAB).
      palette: (K, 3) f32 palette in the same feature space.

    Returns:
      (P,) int32: the first index of the highest score f . c_k - |c_k|^2 / 2;
      -1 for a pixel whose scores are all NaN.
    """
    if features.dim() != 2 or features.shape[1] != 3:
        raise ValueError(f"features must be (P, 3), got {tuple(features.shape)}")
    if palette.dim() != 2 or palette.shape[1] != 3 or palette.shape[0] == 0:
        raise ValueError(f"palette must be (K, 3) with K > 0, got {tuple(palette.shape)}")
    for name, t in (("features", features), ("palette", palette)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if palette.device != features.device:
        raise ValueError(f"palette is on {palette.device}, features on {features.device}")
    if features.device.type == "cpu":
        return assign_idx_reference(features, palette)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    P, K = features.shape[0], palette.shape[0]
    idx = torch.empty(P, dtype=torch.int32, device=features.device)
    if P == 0:
        return idx
    features = features.contiguous()
    palette = palette.contiguous()
    lib = _cuda.library()
    assign_idx.launches += 1
    _cuda.check(
        lib.hq_assign_idx(
            features.data_ptr(), palette.data_ptr(), P, K, idx.data_ptr(),
            _cuda.stream(features.device),
        ),
        "hq_assign_idx",
    )
    return idx


#: launches of the CUDA kernel through this wrapper (not of the plain version)
assign_idx.launches = 0
