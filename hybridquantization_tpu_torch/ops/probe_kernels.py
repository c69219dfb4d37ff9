"""The assignment probes' kernels (T1–T8), their wrappers and plain versions.

The TPU package's probe scripts under `tools/` time alternative layouts of
the population assignment B1 (`ops/assign_kernel.py`) as Pallas kernels.
Here each computes one of three functions, and each function has a CUDA
kernel, a wrapper that launches it on a CUDA tensor (or raises), and a
plain torch version that the wrapper runs on a CPU tensor:

  kloop_assign   T1 (`tools/vpu_assign_exp.py`, make_vpu_kernel) and T2
                 (make_grp8_kernel): B1's first-index function in fp32,
                 score (x0 c0 + x1 c1) + (x2 c2 + cb), every product and sum
                 rounded on its own, best starting at -1e30 (a score at or
                 below it never wins, nor does NaN), the winner's opponent
                 colour and int32 counts per entry. `csrc/probe_kloop.cu`.
  split_rowmax   T3 (make_dotprobe_kernel), T5 (minidot _dense_kernel), T6
                 (_mini_kernel), T4's `dotmax`: per member and pixel the max
                 over the candidates of the split-bf16 score, optionally
                 each score rounded to bf16 first (T3's `out_bf16`).
  split_assign   T4 (`tools/kexp_assign.py`, make_kernel at f32x3), T7
                 (_mini_full_kernel), T8 (_mini_full2_kernel): the first
                 index of that score's max (or every maximum, T4's `avg`),
                 the winner's colour from 3 exact or 2 bf16 parts, counts.
                 Both are `csrc/split_assign.cu` (wgmma): split_rowmax is
                 its max mode.

The split-bf16 score is the probes' defining arithmetic: each operand is
split into bf16 hi = bf16(a) and lo = bf16(a - hi), and the 12-deep
contraction [ch; ch; cl] . [xh; xl; xh] over the 4 rows sums exact products
in f32 (`pallas_assign.py:144-148, :177-188`; `minidot_probe.py:42-45`). The
kernels compute it on the tensor cores; the plain versions add the 12
products in contraction order, so the two agree to a few f32 ulps of the
largest product (the tensor core's f32 accumulation is its own).

Candidates are one dense palette per member, c (pop, 4, K), or with
`run` one set per run of `run` pixels, c (pop, ceil(P / run), 4, KC), the
minidot probe's pruning layout. x4 is (4, P): the pixel features and a
fourth row, ones for the packed palettes of T1–T4 (whose row 3 is the bias
-|c|^2/2), random in the minidot probe. Counts are per entry, or per
candidate slot with `run`, as int32 (pop, K); every pixel given is counted.
A NaN score never wins; a pixel whose scores are all NaN gets index -1,
colour 0 and no count (its row max is -inf).
"""

from __future__ import annotations

import torch

from ..config import TIE_MODES
from . import _cuda
from .assign_kernel import DEFAULT_BLOCK, bf16_round

NEG = -1e30  # the k-loop's starting best (vpu_assign_exp.py:93, :154)
SLOTS = (1, 8)
UNROLLS = (1, 4, 8, 16)
FUSED_MAX_POP = 8  # the fused k-loop keeps every member's chain in registers
OPP_PARTS = (2, 3)
DEFAULT_THREADS = 256
# the split kernels stage every member's candidate fragments in shared memory,
MAX_SPLIT_SMEM = 192 * 1024  # with at most 32 KB of counts: under the 227 KB a block may use
SMEM_PER_BLOCK = 232448  # the most dynamic shared memory an H100 block may use (227 KB)
SMEM_PER_SM = 233472  # an SM's shared memory for its blocks (228 KB), 1 KB reserved a block
SMS = 132  # an H100 SXM's SMs: the plans' default when no card is asked

# the k-loop's layout (csrc/probe_kloop.cu): pixels a thread (a slot group),
# entries a max-then-rescan chunk (16 float4s padded to 17 in shared memory),
# entries a streamed tile, the most bytes of resident palettes, shared counts
KLOOP_PX = 4
KLOOP_CHUNK = 16
KLOOP_TILE = 1024
KLOOP_RESIDENT_BYTES = 128 * 1024
KLOOP_HIST_INTS = 4096
FUSED_WIDTHS = (1, 2, 4, 8)  # chains of one pass over k (members rounded up)

# split_assign's layout (csrc/split_assign.cu): a warpgroup's pixels, its
# threads, at most two warpgroups a block (128 registers a thread), the
# candidates of one product (wgmma N), per-run candidate sets in flight,
# shared counts
SPLIT_ROWS = 64
SPLIT_WARPGROUP = 128
SPLIT_MAX_WARPGROUPS = 2
SPLIT_NBS = (64, 128)  # candidates of one product: 64 up to 64 candidates, else 128
SPLIT_STAGES = 3
SPLIT_HIST_INTS = 8192


def _sms(dev: torch.device | None) -> int:
    if dev is None or dev.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(dev).multi_processor_count


def kloop_plan(P: int, K: int, pop: int, *, slots: int = 1, fused: bool = False,
               threads: int = DEFAULT_THREADS, sms: int = SMS) -> dict:
    """The k-loop kernel's launch: members a pass over k (`width`), the
    staged tile (entries, float4s with chunk padding), members staged and
    whether they stay resident for the whole launch, shared counts, shared
    bytes, pixels a block tile, and the persistent grid (`blocks`, striding
    over `tiles`). Block b takes tiles b, b + blocks, ...; in tile t, pixel
    group g (of `slots` lanes) holds pixels t x block_px + r x groups + g,
    r < KLOOP_PX."""
    width = next(w for w in FUSED_WIDTHS if w >= pop) if fused else 1
    step = KLOOP_CHUNK * slots  # entries of one chunk of every lane

    def float4s(n):
        return -(-n // step) * step // KLOOP_CHUNK * (KLOOP_CHUNK + 1)

    staged_all = -(-pop // width) * width
    resident = K <= KLOOP_TILE and staged_all * float4s(K) * 16 <= KLOOP_RESIDENT_BYTES
    tile = K if resident else min(K, KLOOP_TILE)
    staged = staged_all if resident else width
    tile_f4 = float4s(tile)
    shared_hist = pop * K <= KLOOP_HIST_INTS
    smem = staged * tile_f4 * 16 + (4 * pop * K if shared_hist else 0)
    groups = threads // slots
    block_px = groups * KLOOP_PX
    tiles = -(-P // block_px)
    per_sm = max(1, min(2048 // threads, SMEM_PER_SM // (smem + 1024)))
    return dict(width=width, tile=tile, tile_f4=tile_f4, staged=staged, resident=resident,
                shared_hist=shared_hist, smem=smem, groups=groups, block_px=block_px, tiles=tiles,
                blocks=max(1, min(tiles, sms * per_sm)))


def split_assign_plan(P: int, Kc: int, pop: int, *, run: int | None = None, average: bool = False,
                      max_only: bool = False, threads: int = DEFAULT_THREADS, sms: int = SMS) -> dict:
    """split_assign's launch, or with `max_only` split_rowmax's (the same
    kernel's max mode): the candidates of one product (`nb`), the
    candidates padded to whole products (`kpad`, `chunks` products a member), warpgroups a block,
    shared counts, shared bytes (B: one a block, or with `run` one a
    warpgroup beside its ring of SPLIT_STAGES raw sets; average mode's hit
    masks; each warpgroup's merged rows; counts: the kernel's order; max
    mode keeps B and the rings alone), and
    the persistent grid (an upper
    bound: the kernel caps it at what fits on the SMs at once). Warpgroup w
    of block b is warpgroup number b x wgs + w of the grid's blocks x wgs;
    dense, it takes the 64-pixel tiles of its number, then + blocks x wgs,
    ...; with `run`, the runs of its number, then + blocks x wgs, ..., each
    run's tiles in turn. `smem` may exceed SMEM_PER_BLOCK: the wrapper then
    refuses the shape."""
    nb = SPLIT_NBS[0] if Kc <= SPLIT_NBS[0] else SPLIT_NBS[1]
    kpad = -(-Kc // nb) * nb
    chunks = kpad // nb
    wgs = min(SPLIT_MAX_WARPGROUPS, max(1, threads // SPLIT_WARPGROUP))
    shared_hist = not max_only and pop * Kc <= SPLIT_HIST_INTS
    b = pop * kpad * 32
    if run:
        b = wgs * (b + SPLIT_STAGES * pop * 4 * Kc * 4)
    masks = wgs * pop * SPLIT_ROWS * chunks * 16 if average else 0
    # merged rows, a spare slot (max mode stores from registers)
    rows = 0 if max_only else wgs * (pop * SPLIT_ROWS * (6 if average else 1) + 8) * 4
    smem = b + masks + rows + (4 * pop * Kc if shared_hist else 0)
    work = -(-P // run) if run else -(-P // SPLIT_ROWS)  # runs or tiles
    per_sm = max(1, min(2048 // (wgs * SPLIT_WARPGROUP), SMEM_PER_SM // (smem + 1024)))
    return dict(nb=nb, kpad=kpad, chunks=chunks, wgs=wgs, shared_hist=shared_hist, smem=smem, work=work,
                blocks=max(1, min(-(-work // wgs), sms * per_sm)))


def pack_palette(pal_feats: torch.Tensor, opp_palette: torch.Tensor):
    """(..., K, 3) palette features and opponent colours -> (c4, o4), each
    (..., 4, K): rows c0, c1, c2, -|c|^2/2 and o0, o1, o2, 1, as JAX's
    `pack_palette` (without its padding to a multiple of 8)."""
    bias = -0.5 * torch.sum(pal_feats * pal_feats, dim=-1, keepdim=True)
    ones = torch.ones_like(bias)
    c4 = torch.cat([pal_feats, bias], dim=-1).transpose(-1, -2).contiguous()
    o4 = torch.cat([opp_palette, ones], dim=-1).transpose(-1, -2).contiguous()
    return c4, o4


def split2(a: torch.Tensor):
    """f32 ~ hi + lo with bf16 parts (returned as f32 tensors)."""
    hi = bf16_round(a)
    return hi, bf16_round(a - hi)


def colour_parts(o: torch.Tensor, parts: int) -> torch.Tensor:
    """The colour the one-hot gather reconstructs from `parts` bf16 parts:
    3 gives o exactly ((hi + mid) + lo, `pallas_assign.py:151-159, :287`),
    2 gives hi + bf16(o - hi) (`minidot_probe.py:112-121`)."""
    hi, mid = split2(o)
    if parts == 2:
        return hi + mid
    return (hi + mid) + bf16_round((o - hi) - mid)


def _split_scores(xr: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """(R, n, Kc) split-bf16 scores of pixels xr (4, R, n) against candidates
    cr (R, 4, Kc): the 12 exact products summed in contraction order."""
    xh, xl = split2(xr)
    ch, cl = split2(cr)
    s = None
    for xs, cs in ((xh, ch), (xl, ch), (xh, cl)):
        for r in range(4):
            prod = xs[r][:, :, None] * cs[:, r, None, :]
            s = prod if s is None else s + prod
    return s


def _blocks(x4: torch.Tensor, c: torch.Tensor, p: int, run: int | None, block_size: int):
    """Member p's split scores block by block: yields (first pixel, (n, Kc))."""
    P = x4.shape[1]
    if run is None:
        for lo in range(0, P, block_size):
            xb = x4[:, lo : lo + block_size]
            yield lo, _split_scores(xb[:, None, :], c[p][None])[0]
        return
    R, KC = c.shape[1], c.shape[-1]
    per = max(1, block_size // run)
    for r0 in range(0, R, per):
        r1 = min(R, r0 + per)
        lo, hi = r0 * run, min(P, r1 * run)
        xb = torch.nn.functional.pad(x4[:, lo:hi], (0, (r1 - r0) * run - (hi - lo)))
        s = _split_scores(xb.reshape(4, r1 - r0, run), c[p, r0:r1])
        yield lo, s.reshape(-1, KC)[: hi - lo]


def _nan_low(s: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(s), float("-inf"), s)


def _first_max(s: torch.Tensor, floor: float = float("-inf")):
    """(best, int64 first index of the max, -1 where no score exceeds `floor`)."""
    best, arg = torch.max(_nan_low(s), dim=-1)
    return best, torch.where(best > floor, arg, -1)


def _check_common(x4, c, o=None):
    if x4.dim() != 2 or x4.shape[0] < 3:
        raise ValueError(f"x must be (3 or 4, P), got {tuple(x4.shape)}")
    for name, t in (("x", x4), ("c", c), ("o", o)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x4.device:
            raise ValueError(f"{name} is on {t.device}, x on {x4.device}")
    if o is not None and o.shape != c.shape:
        raise ValueError(f"o {tuple(o.shape)} != c {tuple(c.shape)}")


# ---------------------------------------------------------------------------
# T1, T2: the k-loop
# ---------------------------------------------------------------------------

def kloop_assign_reference(x, c4, o4, *, block_size: int = DEFAULT_BLOCK):
    """Plain version of the k-loop kernel: (opp (pop, 3, P), counts (pop, K) int32)."""
    pop, _, K = c4.shape
    P = x.shape[1]
    idx = torch.empty((pop, P), dtype=torch.int64, device=x.device)
    for p in range(pop):
        c0, c1, c2, cb = c4[p]
        for lo in range(0, P, block_size):
            x0, x1, x2 = (x[r, lo : lo + block_size, None] for r in range(3))
            s = (x0 * c0 + x1 * c1) + (x2 * c2 + cb)
            idx[p, lo : lo + block_size] = _first_max(s, NEG)[1]
    return _gather_first(o4[:, :3], idx, K, False)


def _gather_first(oc, idx, K, return_index, run=None):
    """Winner colours from per-candidate colours oc ((pop, 3, K), or (pop, R,
    3, KC) with `run`), 0 where idx is -1, and int32 counts of idx >= 0."""
    pop, P = idx.shape
    won = idx >= 0
    k = idx.clamp_min(0)
    if run is None:
        opp = torch.gather(oc, 2, k[:, None, :].expand(pop, 3, P))
    else:
        rr = torch.arange(P, device=idx.device) // run
        opp = torch.stack([oc[p][rr, :, k[p]].T for p in range(pop)])
    opp = torch.where(won[:, None, :], opp, 0.0)
    counts = torch.stack([torch.bincount(i[i >= 0], minlength=K) for i in idx]).to(torch.int32)
    out = (opp.contiguous(), counts)
    return (*out, idx.to(torch.int32)) if return_index else out


def kloop_assign(x, c4, o4, *, slots: int = 1, fused: bool = False, unroll: int = 8,
                 threads: int = DEFAULT_THREADS):
    """B1's first-index function through the k-loop kernel (T1, T2).

    Args:
      x: (3 or 4, P) f32 pixel features (a fourth row is ignored).
      c4: (pop, 4, K) f32 packed palettes (rows c0, c1, c2, bias).
      o4: (pop, 4, K) f32 opponent colours (row 3 ignored).
      slots: 1 (one thread per pixel scans K, T1) or 8 (eight lanes of a
        warp share a pixel, lane j scanning entries j, j + 8, ..., T2).
      fused: every member's compare chain in one pass over k (T1's `fused`).
      unroll: 1, 4, 8 or 16 entries per step of the scan.
      threads: threads per CUDA block (a variant whose registers do not
        allow that many raises at launch).

    Returns:
      (opp (pop, 3, P) f32, counts (pop, K) int32). Schedule arguments
      change nothing in the result.
    """
    _check_common(x, c4, o4)
    if c4.dim() != 3 or c4.shape[1] != 4:
        raise ValueError(f"c4 must be (pop, 4, K), got {tuple(c4.shape)}")
    if slots not in SLOTS or unroll not in UNROLLS:
        raise ValueError(f"slots {slots} (options {SLOTS}), unroll {unroll} (options {UNROLLS})")
    pop, _, K = c4.shape
    if fused and pop > FUSED_MAX_POP:
        raise ValueError(f"fused takes at most {FUSED_MAX_POP} members, got {pop}")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], got {threads}")
    if x.device.type == "cpu":
        return kloop_assign_reference(x, c4, o4)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    P = x.shape[1]
    x, c4, o4 = x.contiguous(), c4.contiguous(), o4.contiguous()
    opp = torch.empty((pop, 3, P), dtype=torch.float32, device=x.device)
    counts = torch.zeros((pop, K), dtype=torch.int32, device=x.device)
    if P == 0:
        return opp, counts
    plan = kloop_plan(P, K, pop, slots=slots, fused=fused, threads=threads, sms=_sms(x.device))
    lib = _cuda.library()
    kloop_assign.launches += 1
    _cuda.check(
        lib.hq_probe_kloop(
            x.data_ptr(), c4.data_ptr(), o4.data_ptr(), P, K, pop, slots, plan["width"], unroll,
            threads, plan["blocks"], plan["tile"], plan["tile_f4"], plan["staged"],
            int(plan["resident"]), int(plan["shared_hist"]), plan["smem"], opp.data_ptr(),
            counts.data_ptr(), _cuda.stream(x.device),
        ),
        "hq_probe_kloop",
    )
    return opp, counts


#: launches of the CUDA kernel through this wrapper (not of the plain version)
kloop_assign.launches = 0


# ---------------------------------------------------------------------------
# T3–T8: split-bf16 scores on the tensor cores
# ---------------------------------------------------------------------------

def _check_split(x4, c, o, run, threads):
    _check_common(x4, c, o)
    if x4.shape[0] != 4:
        raise ValueError(f"x4 must be (4, P), got {tuple(x4.shape)}")
    P = x4.shape[1]
    if run is None:
        if c.dim() != 3 or c.shape[1] != 4:
            raise ValueError(f"dense c must be (pop, 4, K), got {tuple(c.shape)}")
    else:
        if run < 1:
            raise ValueError(f"run must be positive, got {run}")
        R = -(-P // run)
        if c.dim() != 4 or c.shape[1] != R or c.shape[2] != 4:
            raise ValueError(f"c with run={run} must be (pop, {R}, 4, KC), got {tuple(c.shape)}")
    if c.shape[-1] < 1:
        raise ValueError("no candidates")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], got {threads}")
    pop, kc = c.shape[0], c.shape[-1]
    if pop * (-(-kc // 8) * 8) * 32 > MAX_SPLIT_SMEM:
        raise ValueError(f"pop {pop} x {kc} candidates exceed the split kernels' shared memory")


def split_rowmax_reference(x4, c, *, run=None, out_bf16=False, block_size=DEFAULT_BLOCK):
    """Plain version of `split_rowmax`: (pop, P) f32."""
    pop, P = c.shape[0], x4.shape[1]
    out = torch.empty((pop, P), dtype=torch.float32, device=x4.device)
    for p in range(pop):
        for lo, s in _blocks(x4, c, p, run, block_size):
            if out_bf16:
                s = bf16_round(s)
            out[p, lo : lo + s.shape[0]] = _nan_low(s).amax(-1)
    return out


def split_rowmax(x4, c, *, run=None, out_bf16=False, threads=DEFAULT_THREADS):
    """Per member and pixel, the max over the candidates of the split-bf16
    score (T3, T5, T6; T4's `dotmax`), each score rounded to bf16 (to
    nearest, ties to even) first when `out_bf16` (T3's bf16 output). The
    kernel is split_assign's in max mode; it refuses the shapes that
    split_assign refuses in first mode, on every device.

    Args:
      x4: (4, P) f32 pixels.
      c: (pop, 4, K) f32 candidates, or (pop, ceil(P / run), 4, KC) with `run`.
      run: pixels per candidate set (None: one dense set per member).
      threads: threads per CUDA block, in whole warpgroups of 128 (rounded
        down, at least one, at most two).

    Returns:
      (pop, P) f32; -inf where every score is NaN.
    """
    _check_split(x4, c, None, run, threads)
    pop, P, kc = c.shape[0], x4.shape[1], c.shape[-1]
    plan = _rowmax_plan(P, kc, pop, run, threads, _sms(x4.device))
    if x4.device.type == "cpu":
        return split_rowmax_reference(x4, c, run=run, out_bf16=out_bf16)
    if x4.device.type != "cuda":
        raise ValueError(f"unsupported device {x4.device}")
    x4, c = x4.contiguous(), c.contiguous()
    out = torch.empty((pop, P), dtype=torch.float32, device=x4.device)
    if P == 0:
        return out
    lib = _cuda.library()
    split_rowmax.launches += 1
    _cuda.check(
        lib.hq_split_rowmax(
            x4.data_ptr(), c.data_ptr(), P, kc, pop, run or 0, int(out_bf16), plan["nb"],
            plan["wgs"], plan["blocks"], plan["smem"], out.data_ptr(), _cuda.stream(x4.device),
        ),
        "hq_split_rowmax",
    )
    return out


#: launches of the CUDA kernel through this wrapper (not of the plain version)
split_rowmax.launches = 0


def _assign_plan(P, kc, pop, run, tie_mode, threads, sms=SMS) -> dict:
    """split_assign_plan, or ValueError where its shared memory exceeds a block's."""
    plan = split_assign_plan(P, kc, pop, run=run, average=tie_mode == "average", threads=threads,
                             sms=sms)
    if plan["smem"] > SMEM_PER_BLOCK:
        raise ValueError(f"pop {pop} x {kc} candidates exceed split_assign's shared memory "
                         f"({plan['smem']} bytes, tie_mode {tie_mode!r}, run {run})")
    return plan


def _rowmax_plan(P, kc, pop, run, threads, sms=SMS) -> dict:
    """split_rowmax's plan (max mode, which needs fewer shared bytes than
    first mode); ValueError where first mode's plan is refused."""
    _assign_plan(P, kc, pop, run, "first", threads, sms)
    return split_assign_plan(P, kc, pop, run=run, max_only=True, threads=threads, sms=sms)


def split_assign_reference(x4, c, o, *, run=None, tie_mode="first", opp_parts=3,
                           return_index=False, block_size=DEFAULT_BLOCK):
    """Plain version of `split_assign`: (opp (pop, 3, P), counts (pop, Kc)
    int32[, idx (pop, P) int32])."""
    pop, P, kc = c.shape[0], x4.shape[1], c.shape[-1]
    oc = colour_parts(o[..., :3, :], opp_parts)  # (pop, 3, K) or (pop, R, 3, KC)
    idx = torch.empty((pop, P), dtype=torch.int64, device=x4.device)
    if tie_mode == "first":
        for p in range(pop):
            for lo, s in _blocks(x4, c, p, run, block_size):
                idx[p, lo : lo + s.shape[0]] = _first_max(s)[1]
        return _gather_first(oc, idx, kc, return_index, run)
    opp = torch.zeros((pop, 3, P), dtype=torch.float32, device=x4.device)
    counts = torch.zeros((pop, kc), dtype=torch.int64, device=x4.device)
    ks = torch.arange(kc, device=x4.device)
    for p in range(pop):
        for lo, s in _blocks(x4, c, p, run, block_size):
            n = s.shape[0]
            best, first = _first_max(s)
            won = first >= 0
            hit = (s == best[:, None]) & won[:, None]
            counts[p] += hit.sum(0)
            idx[p, lo : lo + n] = first
            rr = torch.arange(lo, lo + n, device=x4.device) // (run or 1)

            def colour(k, rows):
                return oc[p][:, k].T if run is None else oc[p][rr[rows], :, k]

            # the hits' colours summed in index order from the first; only
            # pixels with two or more hits need the later ones
            every = torch.arange(n, device=x4.device)
            acc = torch.where(won[:, None], colour(first.clamp_min(0), every), 0.0)
            many = torch.nonzero(hit.sum(-1) > 1)[:, 0]
            if many.numel():
                h = hit[many]
                later = torch.sort(torch.where(h, ks, kc), dim=-1).values[:, 1:]
                sub = acc[many]
                for r in range(int(h.sum(-1).max()) - 1):
                    k = later[:, r]
                    sub = torch.where((k < kc)[:, None], sub + colour(k.clamp(max=kc - 1), many), sub)
                acc[many] = sub
            opp[p, :, lo : lo + n] = acc.T
    out = (opp, counts.to(torch.int32))
    return (*out, idx.to(torch.int32)) if return_index else out


def split_assign(x4, c, o, *, run=None, tie_mode="first", opp_parts=3, return_index=False,
                 threads=DEFAULT_THREADS):
    """The split-bf16 score's assignment (T4 at f32x3, T7, T8).

    Args:
      x4: (4, P) f32 pixels.
      c, o: candidates and their opponent colours, (pop, 4, K), or with
        `run` (pop, ceil(P / run), 4, KC); row 3 of o is ignored.
      run: pixels per candidate set (None: one dense set per member).
      tie_mode: "first": the first index of the max wins, counts are pixel
        counts; "average" (T4's `avg`): every maximum is a hit, the colour is
        the undivided sum of the hits' colours in index order, and counts
        are hits.
      opp_parts: 3 (the exact gather, T4) or 2 (hi + lo, T7 and T8).
      return_index: also return the int32 first index of the max, (pop, P).
      threads: threads per CUDA block, in whole warpgroups of 128 (rounded
        down, at least one, at most two).

    Returns:
      (opp (pop, 3, P) f32, counts (pop, Kc) int32[, idx]).
    """
    _check_split(x4, c, o, run, threads)
    if tie_mode not in TIE_MODES or opp_parts not in OPP_PARTS:
        raise ValueError(f"tie_mode {tie_mode!r} (options {TIE_MODES}), opp_parts {opp_parts} "
                         f"(options {OPP_PARTS})")
    pop, P, kc = c.shape[0], x4.shape[1], c.shape[-1]
    plan = _assign_plan(P, kc, pop, run, tie_mode, threads, _sms(x4.device))
    kw = dict(run=run, tie_mode=tie_mode, opp_parts=opp_parts, return_index=return_index)
    if x4.device.type == "cpu":
        return split_assign_reference(x4, c, o, **kw)
    if x4.device.type != "cuda":
        raise ValueError(f"unsupported device {x4.device}")
    x4, c, o = x4.contiguous(), c.contiguous(), o.contiguous()
    dev = x4.device
    opp = torch.empty((pop, 3, P), dtype=torch.float32, device=dev)
    counts = torch.zeros((pop, kc), dtype=torch.int32, device=dev)
    idx = torch.empty((pop, P), dtype=torch.int32, device=dev) if return_index else None
    out = (opp, counts, idx) if return_index else (opp, counts)
    if P == 0:
        return out
    lib = _cuda.library()
    split_assign.launches += 1
    _cuda.check(
        lib.hq_split_assign(
            x4.data_ptr(), c.data_ptr(), o.data_ptr(), P, kc, pop, run or 0,
            int(tie_mode == "average"), opp_parts, plan["nb"], plan["wgs"], plan["blocks"],
            int(plan["shared_hist"]), plan["smem"], opp.data_ptr(), counts.data_ptr(),
            idx.data_ptr() if idx is not None else None, _cuda.stream(dev),
        ),
        "hq_split_assign",
    )
    return out


#: launches of the CUDA kernel through this wrapper (not of the plain version)
split_assign.launches = 0
