"""Nearest-palette assignment kernels: B1 and B3, their wrappers and their
plain versions.

B1 replaces the TPU kernel `hybridquantization_tpu/ops/pallas_assign.py`
(`_assign_opp_pop_kernel`, launched by `assign_opp_pop`). For every image
of a bucket, every member of its population of palettes and every pixel:
the nearest palette entries by score f . c_k - |c_k|^2 / 2 (NaN never
wins), the winner's opponent color, and int32 per-entry counts, whose
`> 0` are the usage flags. Its two tie modes and two score precisions are
the Pallas kernel's:

  tie_mode "first"    the first index of the maximum wins (the reference's
                      strict-less scan); counts are pixel counts.
  tie_mode "average"  every entry that reaches the maximum is a hit: the
                      color is the sum of the hits' opponent colors (in
                      index order) times 1 / max(hits, 1), and each hit
                      adds one to its entry's count, so counts are hits,
                      not pixels (`pallas_assign.py:231-235, :262-267,
                      :288-290`; JAX's `usage_counts` refuses them).
  precision "bf16"    the TPU's single-pass DEFAULT dot: features and
                      palette coordinates rounded to bf16, the bias formed
                      in f32 from the unrounded palette and then rounded
                      (`pack_palette`), products exact in f32, sums in f32.
  "highest", "f32x3"  fp32.

B3 replaces `_assign_idx_kernel` of the same file (launched by
`assign_idx`) and the `segment_sum` JAX takes beside it in every Lloyd
step (`ops/assign.py:175-176`, `ops/kmeans.py:104-107`). It runs a batch
of problems in one grid, each a feature set (an image's pixels or
histogram bins, optionally weighted) against one palette, with M palettes
to a feature set (the members of one image): the axes JAX vmaps. Its index
mode (`assign_idx`) gives the int32 nearest index per row, fp32, first
index on ties; its Lloyd-step mode (`lloyd_step`) gives each palette
moved to the weighted means of its rows (`centroid_update`'s float64 sums,
reduced in the kernel in a fixed order). Every one-palette lookup of the
engine runs it: the k-means seeding's and the polish's Lloyd steps
(ops.kmeans, ops.assign), a bucket's or an image's in one launch a step,
and quantize (ops.assign.nearest_palette), a bucket's in one launch.

On a CUDA tensor `assign_opp_usage_pop`, `assign_idx` and `lloyd_step`
launch the hand-written kernels in `csrc/assign_pop.cu` and
`csrc/assign_idx.cu` (built at first use, ops/_cuda.py) or raise; on a CPU
tensor they run their `*_reference` versions. The TPU layout devices
(pick_block, x4/c4 packing with a bias row, lane folds, padded pixels) are
not needed: the kernels tile K through shared memory and take the true P.
B1 takes an optional leading image axis (the JAX batch engine vmaps the
pallas_call over a bucket, `parallel/fast.py:191-196`); one launch serves
the bucket.

One deliberate difference from the Pallas kernels: there a NaN score makes
the pixel's max NaN, so no entry of that palette wins (B3 then writes
K_pad, which segment_sum drops). Here a NaN score never wins, the other
entries compete as usual, and a pixel whose scores are all NaN gets -1.
"""

from __future__ import annotations

import torch

from ..config import PRECISIONS, TIE_MODES
from ..metrics import span
from . import _cuda

DEFAULT_BLOCK = 1 << 16


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def scores(pixels: torch.Tensor, palette: torch.Tensor, precision: str = "f32x3") -> torch.Tensor:
    """(P, K) f32 scores p . c_k - |c_k|^2 / 2 whose argmax is the nearest entry.

    The contraction is written out over the 3 features (bias first), so no
    matmul precision mode (TF32 on the GPU) can round it. With precision
    "bf16" it repeats B1's bf16 arithmetic bit for bit: the bias is
    -((c0 c0 + c1 c1) + c2 c2) / 2 in f32, rounded to bf16 with the
    features and coordinates, and every product of two bf16 values is
    exact in f32. A NaN score becomes -inf, so it never wins, as the
    kernels' strict scan skips it.
    """
    if precision == "bf16":
        sq = palette * palette
        s = bf16_round(-0.5 * ((sq[:, 0] + sq[:, 1]) + sq[:, 2]))
        pixels, palette = bf16_round(pixels), bf16_round(palette)
    else:
        s = -0.5 * torch.sum(palette * palette, dim=-1)
    for f in range(pixels.shape[-1]):
        s = s + pixels[:, f : f + 1] * palette[:, f]
    return torch.nan_to_num(s, nan=float("-inf"))


def nearest_scan(
    features: torch.Tensor,
    palette: torch.Tensor,
    precision: str = "f32x3",
    block_size: int = DEFAULT_BLOCK,
) -> torch.Tensor:
    """Plain nearest-entry scan at either precision: (P,) int32 first index
    of the highest score, -1 where no score is a number."""
    idx = torch.empty(features.shape[0], dtype=torch.int32, device=features.device)
    for lo in range(0, features.shape[0], block_size):
        block = features[lo : lo + block_size]
        best, arg = torch.max(scores(block, palette, precision), dim=-1)
        # all scores NaN (now -inf): no winner, like the kernels' strict scan
        idx[lo : lo + block.shape[0]] = torch.where(best > float("-inf"), arg, -1).to(torch.int32)
    return idx


def _average_member(features, pal, opp_pal, precision, block_size):
    """tie_mode "average" for one member: (opp (3, P), counts (K,) int64,
    idx (P,) int32), the colour summed over the hits in index order from the
    first, as the kernel sums it."""
    P, K = features.shape[0], pal.shape[0]
    dev = features.device
    opp = torch.empty((P, 3), dtype=torch.float32, device=dev)
    idx = torch.empty(P, dtype=torch.int32, device=dev)
    counts = torch.zeros(K, dtype=torch.int64, device=dev)
    ks = torch.arange(K, device=dev)
    for lo in range(0, P, block_size):
        s = scores(features[lo : lo + block_size], pal, precision)
        best, first = torch.max(s, dim=-1)
        won = best > float("-inf")
        hit = (s == best[:, None]) & won[:, None]
        n = hit.sum(-1)
        acc = opp_pal[first]
        max_n = int(n.max()) if n.numel() else 0
        if max_n > 1:
            # the later hits of each pixel, in index order
            later = torch.sort(torch.where(hit, ks, K), dim=-1).values[:, 1:max_n]
            for r in range(max_n - 1):
                k = later[:, r]
                acc = torch.where((k < K)[:, None], acc + opp_pal[k.clamp(max=K - 1)], acc)
        inv = 1.0 / n.clamp_min(1).to(torch.float32)
        opp[lo : lo + s.shape[0]] = torch.where(won[:, None], acc * inv[:, None], 0.0)
        idx[lo : lo + s.shape[0]] = torch.where(won, first, -1).to(torch.int32)
        counts += hit.sum(0)
    return opp.T, counts, idx


def assign_opp_usage_pop_reference(
    features: torch.Tensor,
    pal_feats: torch.Tensor,
    opp_palettes: torch.Tensor,
    *,
    precision: str = "f32x3",
    tie_mode: str = "first",
    block_size: int = DEFAULT_BLOCK,
):
    """Plain torch version of the B1 kernel: (opp (pop, 3, P) f32, counts
    (pop, K) int32, idx (pop, P) int32), each with the leading image axis of
    the inputs if they have one (each image run on its own)."""
    kw = dict(precision=precision, tie_mode=tie_mode, block_size=block_size)
    if features.dim() == 3:
        outs = [
            assign_opp_usage_pop_reference(f, p, o, **kw)
            for f, p, o in zip(features, pal_feats, opp_palettes)
        ]
        return tuple(torch.stack(t) for t in zip(*outs))
    pop, K, _ = pal_feats.shape
    P = features.shape[0]
    if tie_mode == "average":
        members = [
            _average_member(features, pal_feats[p], opp_palettes[p], precision, block_size)
            for p in range(pop)
        ]
        opp, counts, idx = (torch.stack(t) for t in zip(*members))
        return opp.contiguous(), counts.to(torch.int32), idx
    idx = torch.stack(
        [nearest_scan(features, pal_feats[p], precision, block_size) for p in range(pop)]
    ).long()
    won = idx >= 0
    opp = torch.gather(opp_palettes, 1, idx.clamp_min(0)[:, :, None].expand(pop, P, 3))
    opp = torch.where(won[:, :, None], opp, 0.0)
    counts = torch.stack([torch.bincount(i[i >= 0], minlength=K) for i in idx])
    return opp.transpose(1, 2).contiguous(), counts.to(torch.int32), idx.to(torch.int32)


def _check(features, pal_feats, opp_palettes, precision, tie_mode):
    if features.dim() not in (2, 3) or features.shape[-1] != 3:
        raise ValueError(f"features must be (P, 3) or (B, P, 3), got {tuple(features.shape)}")
    lead = tuple(features.shape[:-2])
    if (
        pal_feats.dim() != features.dim() + 1
        or pal_feats.shape[-1] != 3
        or tuple(pal_feats.shape[:-3]) != lead
    ):
        want = "(B, pop, K, 3)" if lead else "(pop, K, 3)"
        raise ValueError(f"pal_feats must be {want}, got {tuple(pal_feats.shape)}")
    if opp_palettes.shape != pal_feats.shape:
        raise ValueError(
            f"opp_palettes {tuple(opp_palettes.shape)} != pal_feats {tuple(pal_feats.shape)}"
        )
    for name, t in (("features", features), ("pal_feats", pal_feats), ("opp_palettes", opp_palettes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"{name} is on {t.device}, features on {features.device}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; options: {list(PRECISIONS)}")
    if tie_mode not in TIE_MODES:
        raise ValueError(f"unknown tie_mode {tie_mode!r}; options: {list(TIE_MODES)}")


def assign_opp_usage_pop(
    features: torch.Tensor,
    pal_feats: torch.Tensor,
    opp_palettes: torch.Tensor,
    *,
    precision: str = "f32x3",
    tie_mode: str = "first",
    return_index: bool = False,
):
    """Population-fused assignment (module doc for the modes).

    Args:
      features: (P, 3) f32 pixel features shared by all members (sRGB or
        LAB), or (B, P, 3) for a bucket of B images.
      pal_feats: (pop, K, 3) f32 candidate palettes in the feature space,
        or (B, pop, K, 3).
      opp_palettes: the same palettes in opponent space, shaped alike.
      precision: "highest" | "f32x3" (fp32) | "bf16".
      tie_mode: "first" | "average".
      return_index: also return the int32 first index of each pixel's
        maximum, (pop, P) or (B, pop, P).

    Returns:
      (opp (pop, 3, P) f32, counts (pop, K) int32[, idx]), each with the
      leading B of the inputs. A pixel whose scores are all NaN has no
      winner: opp 0, index -1, no count.
    """
    with span("b1"):
        _check(features, pal_feats, opp_palettes, precision, tie_mode)
        if features.device.type == "cpu":
            opp, counts, idx = assign_opp_usage_pop_reference(
                features, pal_feats, opp_palettes, precision=precision, tie_mode=tie_mode
            )
            return (opp, counts, idx) if return_index else (opp, counts)
        if features.device.type != "cuda":
            raise ValueError(f"unsupported device {features.device}")
        batched = features.dim() == 3
        if not batched:
            features, pal_feats, opp_palettes = features[None], pal_feats[None], opp_palettes[None]
        B, pop, K, _ = pal_feats.shape
        P = features.shape[1]
        features = features.contiguous()
        pal_feats = pal_feats.contiguous()
        opp_palettes = opp_palettes.contiguous()
        dev = features.device
        # scratch for the palettes packed once per call (JAX's pack_palette)
        packed = torch.empty((B, pop, K, 4), dtype=torch.float32, device=dev)
        opp = torch.empty((B, pop, 3, P), dtype=torch.float32, device=dev)
        counts = torch.zeros((B, pop, K), dtype=torch.int32, device=dev)
        idx = torch.empty((B, pop, P), dtype=torch.int32, device=dev) if return_index else None
        lib = _cuda.library()
        assign_opp_usage_pop.launches += 1
        _cuda.check(
            lib.hq_assign_pop(
                features.data_ptr(),
                pal_feats.data_ptr(),
                opp_palettes.data_ptr(),
                B,
                P,
                K,
                pop,
                int(precision == "bf16"),
                int(tie_mode == "average"),
                packed.data_ptr(),
                opp.data_ptr(),
                counts.data_ptr(),
                idx.data_ptr() if idx is not None else None,
                _cuda.stream(dev),
            ),
            "hq_assign_pop",
        )
        out = (opp, counts, idx) if return_index else (opp, counts)
        return out if batched else tuple(t[0] for t in out)


#: launches of the CUDA kernel through this wrapper (not of the plain version)
assign_opp_usage_pop.launches = 0


def _problems(features, palettes, weights=None):
    """Check B3's arguments and lift them to the batched layout: (features
    (F, P, 3), palettes (F, M, K, 3), weights (F, P) or None, batched)."""
    batched = features.dim() == 3
    if features.dim() not in (2, 3) or features.shape[-1] != 3:
        raise ValueError(f"features must be (P, 3) or (F, P, 3), got {tuple(features.shape)}")
    want = 4 if batched else 2
    if (
        palettes.dim() != want
        or palettes.shape[-1] != 3
        or palettes.shape[-2] == 0
        or (batched and palettes.shape[0] != features.shape[0])
    ):
        shape = "(F, M, K, 3)" if batched else "(K, 3)"
        raise ValueError(f"palettes must be {shape} with K > 0, got {tuple(palettes.shape)}")
    if weights is not None and weights.shape != features.shape[:-1]:
        raise ValueError(f"weights must be {tuple(features.shape[:-1])}, got {tuple(weights.shape)}")
    for name, t in (("features", features), ("palettes", palettes), ("weights", weights)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != features.device:
            raise ValueError(f"{name} is on {t.device}, features on {features.device}")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {features.device}")
    if not batched:
        features, palettes = features[None], palettes[None, None]
        weights = None if weights is None else weights[None]
    return features, palettes, weights, batched


def assign_idx_reference(
    features: torch.Tensor, palettes: torch.Tensor, *, block_size: int = DEFAULT_BLOCK
) -> torch.Tensor:
    """Plain torch version of B3's index mode: (P,) int32 nearest index for
    (P, 3) features and a (K, 3) palette, or (F, M, P) for (F, P, 3) and
    (F, M, K, 3), each problem on its own; first index on ties, -1 where
    every score is NaN.

    The port's one plain fp32 nearest-entry scan (B1's plain version runs
    it per member). It works on blocks of pixels, so the (block, K) score
    tile stays bounded: a 4K frame at K=256 would need 8.5 GB unblocked.
    """
    if features.dim() == 3:
        return torch.stack([
            torch.stack([nearest_scan(f, p, "f32x3", block_size) for p in pals])
            for f, pals in zip(features, palettes)
        ])
    return nearest_scan(features, palettes, "f32x3", block_size)


def assign_idx(features: torch.Tensor, palettes: torch.Tensor) -> torch.Tensor:
    """Nearest-palette index of every pixel (B3's index mode).

    Args:
      features: (P, 3) f32 pixel features (sRGB or LAB), or (F, P, 3) for
        F feature sets.
      palettes: (K, 3) f32 palette in the same feature space, or
        (F, M, K, 3): M palettes for each feature set.

    Returns:
      (P,) or (F, M, P) int32: the first index of the highest score
      f . c_k - |c_k|^2 / 2; -1 for a pixel whose scores are all NaN. One
      launch for all F x M problems.
    """
    with span("b3"):
        feats, pals, _, batched = _problems(features, palettes)
        if feats.device.type == "cpu":
            return assign_idx_reference(features, palettes)
        F, M, K, _ = pals.shape
        P = feats.shape[1]
        idx = torch.empty((F, M, P), dtype=torch.int32, device=feats.device)
        if P > 0:
            feats, pals = feats.contiguous(), pals.contiguous()
            lib = _cuda.library()
            assign_idx.launches += 1
            _cuda.check(
                lib.hq_assign_idx(
                    feats.data_ptr(), pals.data_ptr(), F, M, P, K, idx.data_ptr(),
                    _cuda.stream(feats.device),
                ),
                "hq_assign_idx",
            )
        return idx if batched else idx[0, 0]


#: launches of the CUDA kernel through this wrapper (not of the plain version)
assign_idx.launches = 0

#: rows a tile of the B3 kernel: 256 threads x 4 rows (csrc/assign_idx.cu, kRows)
B3_TILE_ROWS = 1024
#: most row blocks of one problem of a Lloyd step: two an SM of an H100 for
#: a lone problem, so the float64 partials stay at most 264 x K x 32 bytes
LLOYD_MAX_BLOCKS = 264
#: most palette entries of the fused Lloyd step, whose float64 sums live in
#: shared memory (csrc/assign_idx.cu, kLloydMaxK; 171 KB of the 227 KB a
#: block may take); above it the step runs as the index mode plus the plain
#: sums (lloyd_step.unfused_launches)
LLOYD_MAX_K = 2048


def lloyd_plan(P: int) -> tuple[int, int]:
    """(row blocks, tiles a block) of one problem of P rows in Lloyd mode.
    It depends on P alone, so a problem's sums, and its output, are the
    same bits whatever else shares its launch."""
    tiles = -(-P // B3_TILE_ROWS)
    per_block = -(-tiles // LLOYD_MAX_BLOCKS)
    return -(-tiles // per_block), per_block


def centroid_update(
    values: torch.Tensor,
    idx: torch.Tensor,
    palette: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Move each palette entry to the (weighted) mean of the rows assigned to
    it; entries no row selected keep their color. Rows with idx -1 (no
    winner) are dropped.

    Sums and totals accumulate in float64 and the mean is cast to float32
    at the end: on the card `index_add_` adds in no fixed order, and fp32
    sums would round differently from run to run, fp32 counts stop being
    exact above 2^24 rows per entry. In float64 both stay exact far beyond
    any image (integer totals to 2^53), so only the final cast rounds.
    The sums of B3's Lloyd-step mode (lloyd_step) are these, in a fixed order.
    """
    K = palette.shape[0]
    keep = idx >= 0
    seg = torch.where(keep, idx, 0).long()
    w = keep.double() if weights is None else torch.where(keep, weights.double(), 0.0)
    rows = torch.where(keep[:, None], values.double(), 0.0) * w[:, None]
    sums = torch.zeros((K, values.shape[1]), dtype=torch.float64, device=values.device)
    sums.index_add_(0, seg, rows)
    tot = torch.zeros(K, dtype=torch.float64, device=values.device).index_add_(0, seg, w)
    mean = (sums / tot.clamp_min(1.0)[:, None]).to(torch.float32)
    return torch.where(tot[:, None] > 0, mean, palette)


def lloyd_step_reference(
    features: torch.Tensor, palettes: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain torch version of B3's Lloyd-step mode: for each problem,
    `centroid_update(features, assign_idx_reference(features, palette),
    palette, weights)`, in lloyd_step's layouts."""
    if features.dim() == 3:
        ws = [None] * features.shape[0] if weights is None else weights
        return torch.stack([
            torch.stack([centroid_update(f, assign_idx_reference(f, p), p, w) for p in pals])
            for f, pals, w in zip(features, palettes, ws)
        ])
    return centroid_update(features, assign_idx_reference(features, palettes), palettes, weights)


def lloyd_step(
    features: torch.Tensor, palettes: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """One Lloyd (k-means) step of every problem (B3's Lloyd-step mode).

    Args:
      features: (P, 3) f32 rows, or (F, P, 3) for F feature sets.
      palettes: (K, 3) f32, or (F, M, K, 3): M palettes for each feature set.
      weights: optional (P,) or (F, P) f32 row weights (default 1).

    Returns:
      the palettes, shaped alike, with every entry moved to the weighted mean
      of the rows whose nearest entry it is (assign_idx); entries with no
      weight keep their colour, rows with no winner (all scores NaN) are
      dropped. The sums are float64, in a fixed order: the same bits run to
      run, and a problem's result does not depend on the others of the call.
      One launch for all problems up to LLOYD_MAX_K entries; above it the
      index mode and centroid_update, problem by problem.
    """
    with span("b3"):
        feats, pals, w, batched = _problems(features, palettes, weights)
        if feats.device.type == "cpu":
            return lloyd_step_reference(features, palettes, weights)
        F, M, K, _ = pals.shape
        P = feats.shape[1]
        if P == 0:
            return palettes.clone()
        feats, pals = feats.contiguous(), pals.contiguous()
        if K > LLOYD_MAX_K:
            lloyd_step.unfused_launches += 1
            idx = assign_idx(feats, pals)
            out = torch.stack([
                torch.stack([centroid_update(f, i, p, wf) for i, p in zip(idxs, ps)])
                for f, idxs, ps, wf in zip(feats, idx, pals, [None] * F if w is None else w)
            ])
            return out if batched else out[0, 0]
        w = None if w is None else w.contiguous()
        blocks, per_block = lloyd_plan(P)
        partials = torch.empty((F, M, blocks, K, 4), dtype=torch.float64, device=feats.device)
        out = torch.empty_like(pals)
        lib = _cuda.library()
        lloyd_step.launches += 1
        _cuda.check(
            lib.hq_lloyd_step(
                feats.data_ptr(), None if w is None else w.data_ptr(), pals.data_ptr(), F, M, P, K,
                blocks, per_block, partials.data_ptr(), out.data_ptr(), _cuda.stream(feats.device),
            ),
            "hq_lloyd_step",
        )
        return out if batched else out[0, 0]


#: launches of the fused CUDA kernel through this wrapper (not of the plain
#: version); unfused_launches: steps above LLOYD_MAX_K entries, run as the
#: index mode (counted on assign_idx) plus centroid_update
lloyd_step.launches = 0
lloyd_step.unfused_launches = 0
