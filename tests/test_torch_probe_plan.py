"""The probe kernels' launch plans (`ops/probe_kernels.kloop_plan`,
`split_assign_plan`), on the CPU: the persistent grids cover every pixel
exactly once, whatever the count of blocks the card lets run at once, and
the shared memory of every shape the wrappers accept fits a block.

The coverage walks repeat the kernels' stride loops as the plans' docstrings
state them (csrc/probe_kloop.cu, csrc/split_assign.cu)."""

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch.ops import probe_kernels as pk

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py


def _kloop_hits(plan, P, blocks):
    """How often each pixel is taken: block b takes tiles b, b + blocks, ...;
    pixel group g of tile t holds t x block_px + r x groups + g."""
    tiles = np.concatenate([np.arange(b, plan["tiles"], blocks) for b in range(blocks)])
    r = np.arange(pk.KLOOP_PX)[:, None] * plan["groups"] + np.arange(plan["groups"])[None, :]
    pix = (tiles[:, None] * plan["block_px"] + r.reshape(-1)[None, :]).reshape(-1)
    return np.bincount(pix[pix < P], minlength=P)


@pytest.mark.parametrize("P,K,pop,slots,fused,threads", [
    (3840 * 2160 // 16, 256, 4, 1, False, 256),
    (52073, 77, 4, 8, False, 256),
    (52073, 77, 3, 1, True, 128),
    (1000, 3, 2, 8, True, 32),
    (1000, 3000, 1, 1, False, 512),
    (1, 16, 8, 8, True, 1024),
])
def test_kloop_grid_covers_every_pixel_once(P, K, pop, slots, fused, threads):
    plan = pk.kloop_plan(P, K, pop, slots=slots, fused=fused, threads=threads)
    assert 1 <= plan["blocks"] <= plan["tiles"]
    assert plan["groups"] * slots == threads
    # the card may run fewer blocks than planned (csrc/persistent_grid.cuh)
    for blocks in {plan["blocks"], 1, 7, min(plan["tiles"], 131)}:
        assert np.array_equal(_kloop_hits(plan, P, blocks), np.ones(P, np.int64)), blocks


@pytest.mark.parametrize("slots", pk.SLOTS)
@pytest.mark.parametrize("fused,pop", [(False, p) for p in (1, 2, 3, 4, 8, 16)]
                         + [(True, p) for p in (1, 2, 3, 4, 8)])
def test_kloop_shared_memory_fits_at_every_k(slots, fused, pop):
    """The k-loop takes any K: resident palettes up to KLOOP_TILE entries,
    streamed tiles of KLOOP_TILE above; either way a block's shared memory
    fits, and a streamed tile holds whole chunks of every lane."""
    step = pk.KLOOP_CHUNK * slots
    for K in (1, 3, 16, 77, 255, 256, 300, 1023, 1024, 1025, 3000, 4096, 10 ** 6):
        plan = pk.kloop_plan(3840 * 2160, K, pop, slots=slots, fused=fused)
        assert plan["smem"] <= pk.SMEM_PER_BLOCK, (K, plan)
        assert plan["width"] >= (pop if fused else 1) and plan["staged"] >= plan["width"]
        assert plan["tile_f4"] * pk.KLOOP_CHUNK >= plan["tile"] * (pk.KLOOP_CHUNK + 1) - step
        if plan["resident"]:
            assert plan["tile"] == K and plan["staged"] >= pop
            assert plan["staged"] * plan["tile_f4"] * 16 <= pk.KLOOP_RESIDENT_BYTES
        else:
            assert plan["tile"] == min(K, pk.KLOOP_TILE) and plan["staged"] == plan["width"]
            if K > plan["tile"]:
                assert plan["tile"] % step == 0


def _split_hits(plan, P, run):
    """How often each pixel is taken by split_assign's grid (see the plan)."""
    hits = np.zeros(P, np.int64)
    nw = plan["blocks"] * plan["wgs"]
    for gw in range(nw):  # warpgroup b x wgs + w of the grid
        if run is None:
            for t in range(gw, -(-P // pk.SPLIT_ROWS), nw):
                hits[t * pk.SPLIT_ROWS:min(P, (t + 1) * pk.SPLIT_ROWS)] += 1
            continue
        for r in range(gw, -(-P // run), nw):
            run1 = min(P, (r + 1) * run)
            for px0 in range(r * run, run1, pk.SPLIT_ROWS):
                hits[px0:min(run1, px0 + pk.SPLIT_ROWS)] += 1
    return hits


@pytest.mark.parametrize("P,Kc,pop,run,threads", [
    (52073, 77, 4, None, 256),
    (8 * 1024, 256, 4, None, 128),
    (1000, 3, 2, None, 32),
    (100, 300, 1, None, 512),  # fewer pixels than one persistent wave
    (52073, 64, 4, 128, 256),
    (52073, 64, 4, 100, 256),
    (8 * 1024, 64, 4, 256, 128),
    (130, 77, 2, 100, 256),
])
@pytest.mark.parametrize("average", [False, True])
def test_split_assign_grid_covers_every_pixel_once(P, Kc, pop, run, threads, average):
    plan = pk.split_assign_plan(P, Kc, pop, run=run, average=average, threads=threads)
    assert plan["nb"] in pk.SPLIT_NBS and plan["kpad"] >= Kc and plan["kpad"] % plan["nb"] == 0
    assert plan["chunks"] * plan["nb"] == plan["kpad"] and plan["kpad"] - Kc < plan["nb"]
    assert 1 <= plan["wgs"] <= pk.SPLIT_MAX_WARPGROUPS
    assert 1 <= plan["blocks"] * plan["wgs"] < plan["work"] + plan["wgs"]
    assert np.array_equal(_split_hits(plan, P, run), np.ones(P, np.int64))
    for blocks in (1, 3):  # the card may run fewer blocks than planned
        assert np.array_equal(_split_hits(dict(plan, blocks=blocks), P, run), np.ones(P, np.int64))


def _accepts(P, kc, pop, run, tie_mode):
    """Whether split_assign takes these shapes (the checks before any launch)."""
    x4 = torch.zeros((4, P))
    c = torch.zeros((pop, 4, kc) if run is None else (pop, -(-P // run), 4, kc))
    try:
        pk._check_split(x4, c, c, run, pk.DEFAULT_THREADS)
        pk._assign_plan(P, kc, pop, run, tie_mode, pk.DEFAULT_THREADS)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("pop", [1, 4, 8])
@pytest.mark.parametrize("run", [None, 128])
@pytest.mark.parametrize("tie_mode", ["first", "average"])
def test_split_assign_shared_memory_fits_at_the_largest_k(pop, run, tie_mode):
    """Every K split_assign accepts (up to the largest) fits a block's
    shared memory; the first K past it is refused."""
    P = 1000
    accepted = [kc for kc in range(8, 6145, 8) if _accepts(P, kc, pop, run, tie_mode)]
    assert accepted and accepted == list(range(8, accepted[-1] + 1, 8))  # no holes
    for kc in (accepted[-1] - 7, accepted[-1]):
        plan = pk.split_assign_plan(P, kc, pop, run=run, average=tie_mode == "average")
        assert plan["smem"] <= pk.SMEM_PER_BLOCK
    assert not _accepts(P, accepted[-1] + 8, pop, run, tie_mode)


def test_max_split_smem_bounds_the_dense_first_index_k():
    """In first mode the candidates' B tile (32 bytes a candidate) is the
    bound: MAX_SPLIT_SMEM // 32 candidates of one member pass, one more
    block of 8 does not, and both split kernels refuse it alike."""
    kmax = pk.MAX_SPLIT_SMEM // 32
    assert _accepts(100, kmax, 1, None, "first") and not _accepts(100, kmax + 8, 1, None, "first")
    c = torch.zeros((1, 4, kmax + 8))
    with pytest.raises(ValueError, match="shared memory"):
        pk.split_rowmax(torch.zeros((4, 100)), c)
    with pytest.raises(ValueError, match="shared memory"):
        pk.split_assign(torch.zeros((4, 100)), c, c)


def test_split_assign_refuses_average_mode_past_its_shared_memory_on_every_device():
    """Average mode keeps hit masks beside B, so its largest K is smaller;
    the CPU call refuses the same shapes the card would."""
    kc = pk.MAX_SPLIT_SMEM // 32
    c = torch.zeros((1, 4, kc))
    assert pk.split_assign_plan(100, kc, 1, average=True)["smem"] > pk.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="split_assign's shared memory"):
        pk.split_assign(torch.zeros((4, 100)), c, c, tie_mode="average")


@pytest.mark.parametrize("P,Kc,pop,run,threads", [
    (52073, 77, 4, None, 256),
    (8 * 1024, 256, 4, None, 128),
    (3840 * 2160 // 64, 200, 4, None, 256),
    (1000, 3, 2, None, 32),
    (100, 300, 1, None, 512),
    (52073, 64, 4, 128, 256),
    (52073, 64, 4, 100, 256),
    (8 * 1024, 64, 4, 256, 128),
    (130, 77, 2, 100, 256),
])
def test_split_rowmax_grid_covers_every_pixel_once(P, Kc, pop, run, threads):
    """Max mode's plan takes first mode's products and walks the grid as
    first mode's does, each pixel once whatever count of blocks runs."""
    plan = pk.split_assign_plan(P, Kc, pop, run=run, max_only=True, threads=threads)
    first = pk.split_assign_plan(P, Kc, pop, run=run, threads=threads)
    for key in ("nb", "kpad", "chunks", "wgs", "work", "blocks"):
        assert plan[key] >= first[key] if key == "blocks" else plan[key] == first[key], key
    assert not plan["shared_hist"] and 1 <= plan["blocks"] * plan["wgs"] < plan["work"] + plan["wgs"]
    assert np.array_equal(_split_hits(plan, P, run), np.ones(P, np.int64))
    for blocks in (1, 3):
        assert np.array_equal(_split_hits(dict(plan, blocks=blocks), P, run), np.ones(P, np.int64))


@pytest.mark.parametrize("run", [None, 128, 100])
@pytest.mark.parametrize("pop", [1, 4, 7])
def test_split_rowmax_plan_needs_fewer_shared_bytes_than_first_mode(pop, run):
    """Max mode keeps no counts, masks or colours: at every K its shared
    bytes are under first mode's, its B the same."""
    for kc in (1, 3, 64, 65, 77, 128, 129, 256, 257, 300, 512, 872):
        plan = pk.split_assign_plan(1000, kc, pop, run=run, max_only=True)
        first = pk.split_assign_plan(1000, kc, pop, run=run)
        assert plan["smem"] < first["smem"] and plan["kpad"] == first["kpad"], (kc, plan, first)


def _rowmax_accepts(P, kc, pop, run):
    """Whether split_rowmax takes these shapes (the checks before any launch)."""
    x4 = torch.zeros((4, P))
    c = torch.zeros((pop, 4, kc) if run is None else (pop, -(-P // run), 4, kc))
    try:
        pk._check_split(x4, c, None, run, pk.DEFAULT_THREADS)
        plan = pk._rowmax_plan(P, kc, pop, run, pk.DEFAULT_THREADS)
    except ValueError:
        return False
    assert plan["smem"] <= pk.SMEM_PER_BLOCK
    return True


@pytest.mark.parametrize("pop", [1, 4, 7, 8])
@pytest.mark.parametrize("run", [None, 128])
def test_split_rowmax_refuses_the_same_k_as_first_mode(pop, run):
    """split_rowmax and split_assign in first mode take the same K (every
    one up to the largest, on every device); the max plan of each fits a block."""
    P = 1000
    ks = range(8, 6145, 8)
    assert [kc for kc in ks if _rowmax_accepts(P, kc, pop, run)] == \
        [kc for kc in ks if _accepts(P, kc, pop, run, "first")]
