"""The layout of B2's split mode on the tensor cores (`csrc/band_fitness.cu`),
held on the CPU, where the kernel cannot run.

The wrapper plans the kernel's tiles (`fused_fitness.band_plan`) and builds
the band tiles it reads (`fused_fitness.band_tables`). Here the tables are
read back through the kernel's descriptor arithmetic (entry top - 2s - 1 +
h + r for core matrix (r, h) of step s, the contraction halves of a step
swapped) and held to the Toeplitz bands of the taps' parts (the core and
the tail of their `split_bf16` hi part, and its lo part); and the
kernel's arithmetic is emulated in plain torch, tile by tile as the kernel
stages and multiplies (one matmul per term of the TPU's three, on f32
copies of the bf16 operands), and held to the plain split
(`fused_fitness._conv_pass(..., "split")`) within 4e-7. The emulation lives
here only; no path runs it. The TPU's f32x3 itself is held against JAX in
tests/test_torch_b2_f32x3.py."""

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.ops.conv import mirror_index
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import SRC7, stacked_kernels

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# the emulated band products against the plain split, relative: the mean
# |difference| of all filter outputs to their mean |output| (0.9e-7 to
# 1.9e-7 measured here; the fp32 mode 1.6e-6 to 7.3e-6), and each member's
# Delta-E sum (under 2.1e-8 measured); the same exact products summed in
# another f32 order (the plain split adds each tap's three in ascending
# order). Outputs are held on average, not one by one: the split of the
# horizontal output into hi and lo is not continuous, so where the two
# orders leave it an f32 ulp apart its lo crosses a bf16 rounding point in
# a few percent of outputs, which moves the vertical pass's output by up to
# 2^-17 of it (1.2e-5 of the largest output measured at 9 taps)
BAND_RTOL = 4e-7
# the fp32 mode's outputs must sit at least this many tolerances from the
# plain split's (its Delta-E sums on these small frames may not: 9.4e-8 to
# 3.2e-6 measured)
TEETH = 3
# (dpi, viewing distance) of real filters of 9, 21, 29, 69 and 97 taps
FILTERS = {9: (30, 45.0), 21: (72, 45.0), 29: (96, 45.0), 69: (222, 45.0), 97: (312, 45.0)}


def _stacks(taps):
    f = build_filters(*FILTERS[taps])
    kh, kv = stacked_kernels(f, False), stacked_kernels(f, True)
    assert kh.shape[1] == taps
    return kh, kv


def _toeplitz(k, rows, cols, offset=0):
    """(7, rows, cols): k[f, c - r + offset] where that is a tap, else 0."""
    idx = torch.arange(cols)[None, :] - torch.arange(rows)[:, None] + offset
    ok = (idx >= 0) & (idx < k.shape[1])
    return torch.where(ok, k[:, idx.clamp(0, k.shape[1] - 1)], torch.zeros(()))


def _contraction_columns(s):
    """The window column (or intermediate row) of each of step s's 16
    contraction positions: the halves swapped, position h x 8 + j at 16 s +
    8 (1 - h) + j."""
    pos = torch.arange(16)
    return 16 * s + 8 * (1 - pos // 8) + pos % 8


def _tables(bands, steps):
    """(7, 3, hcores, 8, 8) and (7, 3, vcores, 8, 8): each filter's
    horizontal and vertical tables (core, tail and lo parts) where the
    kernel finds them among `bands.cores`: the horizontal ones first, a
    vertical one at vmap's base, its parts vmap's stride apart."""
    hcores, vcores = 2 * steps + 7, 2 * steps - 1
    cores = bands.cores.float()
    vmap = list(bands.vmap)
    h = cores[:21 * hcores].reshape(7, 3, hcores, 8, 8)
    v = torch.stack([torch.stack([cores[vmap[f] + part * vmap[7 + f]:][:vcores] for part in range(3)])
                     for f in range(7)])
    return h, v


def _horizontal_band(table, steps):
    """(7, 3, 64, Kp) f32: the band T[m][k] that the kernel's descriptors
    read from a horizontal table, core matrix (m / 8, h) of step s at entry
    2 steps - 2 - 2s + h + m / 8."""
    t = table.float()
    band = torch.zeros((7, 3, 64, 16 * steps))
    m = torch.arange(64)
    for s in range(steps):
        cols = _contraction_columns(s)
        for c in range(16):
            band[:, :, m, cols[c]] = t[:, :, 2 * steps - 2 - 2 * s + c // 8 + m // 8, m % 8, c % 8]
    return band


def _vertical_band(table, steps):
    """(7, 3, Kp, 64) f32: the band V[k][n] that the kernel's descriptors
    read from a vertical table, for each chunk cc of 32 output rows only
    its steps [2 cc, 2 cc + steps - 2): core matrix (n / 8, h) of chunk cc's
    step s at entry 2 steps - 6 - 2s + 4 cc + h + n / 8 (n within the chunk)."""
    t = table.float()
    band = torch.zeros((7, 3, 16 * steps, 64))
    n = torch.arange(32)
    for cc in range(2):
        for s in range(2 * cc, 2 * cc + steps - 2):
            rows = _contraction_columns(s)
            for c in range(16):
                band[:, :, rows[c], 32 * cc + n] += t[:, :, 2 * steps - 6 - 2 * s + 4 * cc + c // 8 + n // 8,
                                                      n % 8, c % 8]
    return band


@pytest.mark.parametrize("taps", sorted(FILTERS))
def test_band_tables_read_as_the_kernel_reads_them_are_the_split_toeplitz(taps):
    kh, kv = _stacks(taps)
    bands = ff.band_tables(kh, kv)
    # |k3| is the vertical pass's last filter: only it takes a vertical table of its own
    own = [f for f in range(7) if not torch.equal(kh[f], kv[f])]
    assert own == [6] and bands.vtables == 1
    plan = ff.band_plan(200, 300, taps, bands.vtables)
    steps = plan["steps"]
    hcores, vcores = plan["cores"]
    assert bands.cores.dtype == torch.bfloat16 and bands.cores.is_contiguous()
    assert bands.cores.shape == (3 * (7 * hcores + vcores), 8, 8)
    assert 128 * bands.cores.shape[0] == plan["smem_bytes"] - 4 * plan["kp"] * plan["nh"] - 2 * 4 * 16 * (plan["kp"] + 4)
    hb, vb = _tables(bands, steps)
    tails = 0
    for bit, k, band in ((0, kh, _horizontal_band(hb, steps)), (7, kv, _vertical_band(vb, steps).transpose(-1, -2))):
        hi, lo = ff.split_bf16(k)
        core, tail, low = ff.band_parts(k).unbind(1)
        # the parts: the core and the tail of the hi part, apart, and the lo part
        assert torch.equal(core + tail, hi) and torch.equal(low, lo) and not (core * tail).any()
        small = hi.abs() < hi.abs().amax(1, keepdim=True) * 2.0 ** -ff.BAND_TAIL
        assert torch.equal(tail != 0, small & (hi != 0))
        tails |= sum(1 << (bit + f) for f in range(7) if (tail[f] != 0).any())
        for part, want in enumerate((core, tail, low)):
            # every tap of every output column (row) inside the contraction
            assert torch.equal(band[:, part], _toeplitz(want, 64, plan["kp"]))
    assert (lo != 0).any() and tails == bands.vmap[14]
    # the contraction reaches the last tap of the last output
    assert plan["kp"] >= 64 + taps - 1 and plan["nh"] >= plan["kp"] and plan["nh"] % ff.BAND_CHUNK == 0


@pytest.mark.parametrize("taps", [1, 3, 9, 21, 29, 69, 95, 97, 99])
def test_fused_plan_takes_the_band_kernel_in_split_mode_up_to_the_tap_limit(taps):
    plan = ff.fused_plan(2160, 3840, taps, split=True)
    if taps > ff.MAX_FUSED_TAPS:
        assert plan == ff.fused_plan(2160, 3840, taps)
        assert plan["path"] == "two_pass"
        return
    assert plan["path"] == "band" and plan["smem_bytes"] <= ff.SMEM_LIMIT
    if taps == 97:
        # seven vertical tables of their own no longer fit a block: the two-pass path
        assert ff.fused_plan(2160, 3840, taps, split=True, vtables=7)["path"] == "two_pass"
    assert plan["rows_per_block"] == ff.BAND_ROWS_PER_BLOCK and plan["rows_per_block"] % ff.BAND_TILE == 0
    assert plan["partials"] == 60 * 9
    # the other modes keep their paths
    assert ff.fused_plan(2160, 3840, taps)["path"] == "fused"
    # a small image takes 64-row segments, so that a population fills the card
    small = ff.fused_plan(70, 300, taps, split=True)
    assert small["rows_per_block"] == 64 and small["partials"] == 5 * 2
    # and one of config-1's size four times as many as 256-row ones
    assert ff.fused_plan(512, 512, taps, split=True)["rows_per_block"] == 64


def test_band_plan_at_the_default_filter():
    """21 taps: 6 steps of 16 (Kp 96, the useful share of a horizontal
    product 21/96), 96 staged rows, and two blocks fit an SM."""
    plan = ff.band_plan(512, 512, ff.DEFAULT_TAPS)
    assert (plan["steps"], plan["kp"], plan["nh"], plan["cores"]) == (6, 96, 96, (19, 11))
    assert plan["smem_bytes"] == 4 * 96 * 96 + 3 * 128 * (7 * 19 + 11) + 2 * 4 * 16 * 100
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    assert plan["partials"] == 8 * 8 and plan["rows_per_block"] == 64
    tall = ff.band_plan(4096, 512, ff.DEFAULT_TAPS)
    assert tall["rows_per_block"] == 256 and tall["partials"] == 8 * 16 >= ff.BAND_MIN_BLOCKS


def test_band_tables_are_made_once_per_pair_of_stacks():
    """A launch takes the tables made for the same two stacks, until one of
    them changes in place; kernel_taps holds only the fused kernel's modes."""
    kh, kv = _stacks(21)
    got = ff.cached_band_tables(kh, kv)
    assert ff.cached_band_tables(kh, kv) is got
    want = ff.band_tables(kh, kv)
    assert torch.equal(got.cores, want.cores) and list(got.vmap) == list(want.vmap)
    assert got.cores.device == kh.device
    kh.mul_(1.0)  # an in-place change, though not of a value
    assert ff.cached_band_tables(kh, kv) is not got
    assert ff.cached_band_tables(kh.clone(), kv) is not ff.cached_band_tables(kh, kv)
    assert sorted(ff.kernel_taps(kh, kv)) == [0, 1]


def _frame(H, W, pop, seed):
    """(q (pop, 3, H, W), target (3, H, W)): opponent images of random
    palettes' colours on a random image, and the image's LAB."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((H, W, 3), dtype=np.float32))
    pals = torch.from_numpy(rng.random((pop, 9, 3), dtype=np.float32))
    opp, _ = ak.assign_opp_usage_pop(img.reshape(-1, 3), pals, tcs.srgb_to_opp(pals))
    return opp.reshape(pop, 3, H, W).contiguous(), torch.movedim(tcs.srgb_to_lab(img), -1, 0).contiguous()


def _emulate(q, kh, kv, left=None, right=None):
    """Split mode's band products as the kernel runs them, in plain torch:
    (pop, 7, H, W) filter outputs. Per tile of 64 x 64 outputs the staged
    window (Kp columns from x0 - half, nh rows from y0 - half; rows
    mirrored and clamped, columns mirrored or from the guards), split into
    bf16 hi and lo; per filter the horizontal product T.X three times
    (th.xh, th.xl, tl.xh), its output split into hi and lo, then the
    vertical product the same way, each one matmul of f32 copies."""
    pop, _, H, W = q.shape
    taps = kh.shape[1]
    half = taps // 2
    plan = ff.band_plan(H, W, taps)
    kp, nh = plan["kp"], plan["nh"]
    hb, vb = _tables(ff.band_tables(kh, kv), plan["steps"])
    T, V = _horizontal_band(hb, plan["steps"]), _vertical_band(vb, plan["steps"])
    # the hi part: its core and its tail
    T, V = torch.stack([T[:, 0] + T[:, 1], T[:, 2]], 1), torch.stack([V[:, 0] + V[:, 1], V[:, 2]], 1)
    # column x0 - half + k of the window is column x0 + k of src
    src = torch.cat([left, q, right], -1) if left is not None else q.index_select(-1, mirror_index(W, half))
    tiles_h, tiles_w = -(-H // 64), -(-W // 64)
    out = torch.zeros((pop, 7, 64 * tiles_h, 64 * tiles_w))
    width = src.shape[-1]
    for ty in range(0, H, 64):
        rows = torch.arange(ty - half, ty - half + nh)
        rows = torch.where(rows < 0, -rows - 1, torch.where(rows >= H, 2 * H - rows - 1, rows)).clamp(0, H - 1)
        for x0 in range(0, W, 64):
            cols = (x0 + torch.arange(kp)).clamp(max=width - 1)  # beyond: only unsummed outputs
            xh, xl = ff.split_bf16(src[:, :, rows][..., cols])  # (pop, 3, nh, kp)
            for f in range(7):
                c = SRC7[f]
                th, tl = T[f, 0], T[f, 1]  # (64, kp)
                d = th @ xh[:, c].mT + th @ xl[:, c].mT + tl @ xh[:, c].mT  # (pop, 64 columns, nh rows)
                ih, il = ff.split_bf16(d[..., :kp])
                y = ih @ V[f, 0] + il @ V[f, 0] + ih @ V[f, 1]  # (pop, 64 columns, 64 rows)
                out[:, f, ty:ty + 64, x0:x0 + 64] = y.mT
    return out[..., :H, :W]


def _plain(q, kh, kv, precision="split", left=None, right=None):
    """The plain version's (pop, 7, H, W) filter outputs (delta_e_reference's passes)."""
    if left is None:
        t = ff._conv_pass(q[:, list(SRC7)], kh, -1, precision, mirrored=True)
    else:
        t = ff._conv_pass(torch.cat([left, q, right], -1)[:, list(SRC7)], kh, -1, precision, mirrored=False)
    return ff._conv_pass(t, kv, -2, precision, mirrored=True)


def _sums(y, target, kind="CIE76"):
    filtered = y[:, 0:3] + y[:, 3:6]
    filtered[:, 0] += y[:, 6]
    lab = tcs.opp_to_lab(torch.movedim(filtered, -3, -1), tcs.WHITEPOINT_D65)
    return tcs.DELTA_E_FNS[kind](torch.movedim(target, 0, -1), lab).double().sum(dim=(1, 2))


def _rel_outputs(got, want):
    """The mean |difference| of the filter outputs relative to their mean |output|."""
    return ((got - want).abs().mean() / want.abs().mean()).item()


def _hold(y, q, target, kh, kv, **guards):
    want = _plain(q, kh, kv, **guards)
    fp32 = _plain(q, kh, kv, "f32x3", **guards)
    assert _rel_outputs(y, want) <= BAND_RTOL
    assert _rel_outputs(fp32, want) >= TEETH * BAND_RTOL
    sums, want_sums = _sums(y, target), _sums(want, target)
    assert ((sums - want_sums).abs() / want_sums).max().item() <= BAND_RTOL


@pytest.mark.parametrize("taps", sorted(FILTERS))
@pytest.mark.parametrize("H,W", [(100, 63), (70, 64), (130, 65)])
def test_emulated_band_products_match_the_plain_split(taps, H, W):
    """Widths one under, at and one over the 64-column strip, heights off
    the 64-row tile, every filter size the tensor-core path takes."""
    kh, kv = _stacks(taps)
    if taps // 2 >= min(H, W):
        pytest.skip("the filter's half-width must be below H and W")
    q, target = _frame(H, W, 2, taps + H)
    _hold(_emulate(q, kh, kv), q, target, kh, kv)


def test_emulated_band_products_on_column_guards():
    """B2s: a shard of 40 columns of a 90 x 150 frame with its neighbours'
    columns as guards; the window's columns come from the guards by index."""
    kh, kv = _stacks(21)
    half = 10
    q, target = _frame(90, 150, 2, 5)
    lo, hi = 60, 100
    guards = {"left": q[..., lo - half:lo].contiguous(), "right": q[..., hi:hi + half].contiguous()}
    shard = q[..., lo:hi].contiguous()
    _hold(_emulate(shard, kh, kv, **guards), shard, target[..., lo:hi], kh, kv, **guards)
