"""The port's k-loop kernel (T1, T2) and split-bf16 row max (T3) against the
JAX package's probe `tools/vpu_assign_exp.py`, whose Pallas kernels run here
in interpret mode: each test builds the probe's pallas_call from its kernel
factory with the probe's BlockSpecs and interpret=True (its `run_*`
functions hard-code the TPU), on 2 blocks of 1024 pixels, pop 4, with
n = P - 77 valid pixels, and feeds the same numpy inputs through
`convert.probe_operands_from_jax_numpy` to the port on the CPU."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hybridquantization_tpu.ops import pallas_assign as pa
from hybridquantization_tpu_torch import convert
from hybridquantization_tpu_torch.ops import probe_kernels as pk

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parent.parent
BLOCK, POP, LANE = 1024, 4, 128
PP = 2 * BLOCK
N = PP - 77
NEAR_TIE_REL = 1e-6  # |top-2 score gap| <= this * max(1, |score|): f32 may pick either


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


vpu = _load("vpu_assign_exp")


def _inputs(K, seed, nan=True):
    """Packed pixels (4, PP) and palettes (pop, 4, kp) as the probe packs
    them, from a palette with an exact duplicate (first-index ties) and,
    with `nan`, a NaN entry."""
    rng = np.random.default_rng(seed)
    feats = rng.random((PP, 3), dtype=np.float32)
    pals = rng.random((POP, K, 3)).astype(np.float32)
    pals[0, 5] = pals[0, 2]
    pals[2, 9] = feats[40]  # wins at least that pixel, with its duplicate
    pals[2, 11] = feats[40]
    if nan:
        pals[1, 7] = np.nan
    c4, o4 = jax.vmap(pa.pack_palette)(jnp.asarray(pals), jnp.asarray(pals))
    return feats, pals, pa.pack_pixels(jnp.asarray(feats), BLOCK), c4, o4


def _near_tie(feats, pals):
    """(pop, n) bool: the two best distinct f64 scores f.c - |c|^2/2 of the
    first N pixels lie within the relative near-tie class (NaN entries and
    exact duplicates left out)."""
    out = []
    for pal in pals:
        c = np.unique(pal[~np.isnan(pal).any(1)].astype(np.float64), axis=0)
        s = feats[:N].astype(np.float64) @ c.T - 0.5 * np.sum(c * c, -1)
        top = np.sort(s, -1)[:, -2:]
        out.append(top[:, 1] - top[:, 0] <= NEAR_TIE_REL * np.maximum(1.0, np.abs(top[:, 1])))
    return np.stack(out)


def _assert_assign_equal(opp, counts, j_opp, j_counts, tie):
    """Colours equal off the near-tie class; counts differ by at most two per
    near-tie pixel."""
    ok = ~tie
    for p in range(POP):
        np.testing.assert_array_equal(opp[p][:, ok[p]], j_opp[p][:, ok[p]])
    assert np.abs(counts - j_counts).sum(1).max() <= 2 * tie.sum(1).max()
    assert (counts.sum(1) == N).all()


def _t1(x4, c4, o4, kp, unroll, fused):
    L = BLOCK // 8
    x4t = x4.reshape(4, -1, 8, L)
    nb = x4t.shape[1]
    cs, os_ = c4.reshape(POP * 4, kp), o4.reshape(POP * 4, kp)
    n = jnp.full((1,), N, jnp.int32)
    opp, usage = pl.pallas_call(
        vpu.make_vpu_kernel(kp, POP, unroll, fused),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3, grid=(nb,),
            in_specs=[pl.BlockSpec((4, 1, 8, L), lambda i, n, c, o: (0, i, 0, 0))],
            out_specs=[
                pl.BlockSpec((POP, 3, 1, 8, L), lambda i, n, c, o: (0, 0, i, 0, 0)),
                pl.BlockSpec((POP, kp, LANE), lambda i, n, c, o: (0, 0, 0)),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((POP, 3, nb, 8, L), jnp.float32),
            jax.ShapeDtypeStruct((POP, kp, LANE), jnp.float32),
        ],
        interpret=True,
    )(n, cs, os_, x4t)
    return (x4t, cs, os_), np.asarray(opp).reshape(POP, 3, PP), np.asarray(usage).sum(2)


def _t2(x4, c4, o4, kp, unroll):
    ct, ot = jnp.transpose(c4, (0, 2, 1)), jnp.transpose(o4, (0, 2, 1))
    opp, usage = pl.pallas_call(
        vpu.make_grp8_kernel(kp, POP, 2, unroll),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(PP // BLOCK,),
            in_specs=[
                pl.BlockSpec((4, BLOCK), lambda i, n: (0, i)),
                pl.BlockSpec((POP, kp, 4), lambda i, n: (0, 0, 0)),
                pl.BlockSpec((POP, kp, 4), lambda i, n: (0, 0, 0)),
            ],
            out_specs=[
                pl.BlockSpec((POP, 3, BLOCK), lambda i, n: (0, 0, i)),
                pl.BlockSpec((POP, kp, LANE), lambda i, n: (0, 0, 0)),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((POP, 3, PP), jnp.float32),
            jax.ShapeDtypeStruct((POP, kp, LANE), jnp.float32),
        ],
        interpret=True,
    )(jnp.full((1,), N, jnp.int32), x4, ct, ot)
    return (x4, ct, ot), np.asarray(opp), np.asarray(usage).sum(2)


@pytest.mark.parametrize(
    "K,unroll,fused", [(64, 8, False), (64, 8, True), (256, 8, False), (256, 16, True), (61, 1, False)]
)
def test_t1_vpu_kloop_matches_jax(K, unroll, fused):
    feats, pals, x4, c4, o4 = _inputs(K, K + unroll)
    kp = c4.shape[-1]
    ops, j_opp, j_use = _t1(x4, c4, o4, kp, unroll, fused)
    x, c, o = convert.probe_operands_from_jax_numpy(*map(np.asarray, ops), n=N)
    assert x.shape == (4, N) and c.shape == (POP, 4, K)
    opp, counts = pk.kloop_assign(x, c, o, slots=1, fused=fused, unroll=unroll)
    _assert_assign_equal(opp.numpy(), counts.numpy(), j_opp[:, :, :N], j_use[:, :K], _near_tie(feats, pals))
    assert counts[1, 7] == 0 and counts[0, 5] == 0 and counts[2, 11] == 0 and counts[2, 9] > 0


@pytest.mark.parametrize("K,unroll", [(64, 1), (256, 4)])
def test_t2_grp8_slots_match_jax(K, unroll):
    feats, pals, x4, c4, o4 = _inputs(K, 3 * K + unroll)
    kp = c4.shape[-1]
    ops, j_opp, j_use = _t2(x4, c4, o4, kp, unroll)
    x, c, o = convert.probe_operands_from_jax_numpy(*map(np.asarray, ops), n=N)
    assert c.shape == (POP, 4, K)
    opp, counts = pk.kloop_assign(x, c, o, slots=8, unroll=unroll)
    _assert_assign_equal(opp.numpy(), counts.numpy(), j_opp[:, :, :N], j_use[:, :K], _near_tie(feats, pals))
    # slots and schedules change nothing: the same as one thread per pixel
    one = pk.kloop_assign(x, c, o, slots=1)
    assert torch.equal(opp, one[0]) and torch.equal(counts, one[1])


def test_operands_convert_from_every_probe_layout():
    """T1's (4, nb, 8, L) / (pop*4, kp) and T2's transposed (pop, kp, 4)
    layouts give the operands of the plain (4, P) / (pop, 4, kp) ones."""
    _, _, x4, c4, o4 = _inputs(61, 0)
    want = convert.probe_operands_from_jax_numpy(np.asarray(x4), np.asarray(c4), np.asarray(o4), n=N)
    kp = c4.shape[-1]
    layouts = [
        (x4.reshape(4, -1, 8, BLOCK // 8), c4.reshape(POP * 4, kp), o4.reshape(POP * 4, kp)),
        (x4, jnp.transpose(c4, (0, 2, 1)), jnp.transpose(o4, (0, 2, 1))),
    ]
    for ops in layouts:
        got = convert.probe_operands_from_jax_numpy(*map(np.asarray, ops), n=N)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert want[1].shape == (POP, 4, 61) and bool((want[0][3] == 1).all())


def _t3(x4, c4, kp, out_bf16):
    return np.asarray(pl.pallas_call(
        vpu.make_dotprobe_kernel(out_bf16),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(PP // BLOCK,),
            in_specs=[
                pl.BlockSpec((4, BLOCK), lambda i, n: (0, i)),
                pl.BlockSpec((POP, 4, kp), lambda i, n: (0, 0, 0)),
            ],
            out_specs=pl.BlockSpec((POP, BLOCK), lambda i, n: (0, i)),
        ),
        out_shape=jax.ShapeDtypeStruct((POP, PP), jnp.float32),
        interpret=True,
    )(jnp.full((1,), N, jnp.int32), x4, c4))


@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("out_bf16", [False, True])
def test_t3_dotprobe_rowmax_matches_jax(K, out_bf16):
    _, _, x4, c4, _ = _inputs(K, 5 * K, nan=False)
    want = _t3(x4, c4, c4.shape[-1], out_bf16)[:, :N]
    x, c, _ = convert.probe_operands_from_jax_numpy(np.asarray(x4), np.asarray(c4), n=N)
    got = pk.split_rowmax(x, c, out_bf16=out_bf16).numpy()
    if out_bf16:
        # interpret mode on the CPU returns the dot in f32 whatever its
        # preferred_element_type; the TPU rounds it to bf16 (to nearest, ties
        # to even), and the max of rounded scores is the rounded max
        want = torch.from_numpy(want).to(torch.bfloat16).to(torch.float32).numpy()
        # one bf16 ulp: the f32 sums may fall on either side of a bf16 rounding boundary
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32)) * 65536
        assert (np.abs(got - want) <= ulp).all()
        assert np.mean(got == want) > 0.99
    else:
        np.testing.assert_array_less(np.abs(got - want), 1e-6 * np.maximum(1.0, np.abs(want)) + 1e-12)
