"""The port's split-bf16 assignment (T4) against the JAX package's probe
`tools/kexp_assign.py`: every variant of its kernel at precision "f32x3",
and `current` at "highest" against B1, built as pallas_calls from
`make_kernel` with the probe's BlockSpecs and interpret=True on 2 blocks of
1024 pixels, pop 4, n = P - 77 valid pixels. The port's side is the tool's
own `run_variant` on the operands `convert.probe_operands_from_jax_numpy`
makes. Palettes hold an exact duplicate (first-index ties) and a NaN entry,
which never wins in the port; the JAX kernel, whose max a NaN score would
poison, gets that entry as a bias of -1e30 and colour 0 instead."""

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
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.tools import kexp_assign as tk

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parent.parent
BLOCK, POP = 1024, 4
PP = 2 * BLOCK
N = PP - 77
NEAR_TIE_REL = 1e-6  # |top-2 score gap| <= this * max(1, |score|): f32 may pick either
ROWMAX_RTOL = 1e-6
AVG_ATOL = 1e-6  # the hits' colours: summed in index order here, on the MXU in JAX


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kexp = _load("kexp_assign")


def _inputs(K, seed):
    rng = np.random.default_rng(seed)
    feats = rng.random((PP, 3), dtype=np.float32)
    pals = rng.random((POP, K, 3)).astype(np.float32)
    pals[0, 5] = pals[0, 2]
    pals[2, 9] = pals[2, 11] = feats[40]  # an exact tie at pixel 40 at least
    pals[1, 7] = np.nan
    c4, o4 = jax.vmap(pa.pack_palette)(jnp.asarray(pals), jnp.asarray(pals))
    c4_jax = c4.at[1, :, 7].set(jnp.array([0.0, 0.0, 0.0, -1e30]))
    o4_jax = o4.at[1, :, 7].set(0.0)  # the one-hot gather would spread a NaN colour
    return feats, pals, pa.pack_pixels(jnp.asarray(feats), BLOCK), c4, o4, c4_jax, o4_jax


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).to(torch.float64).numpy()


def _scores64(x4, c4, split):
    """(pop, N, K) f64 scores of the first N pixels: the split-bf16 sum
    exactly (its 12 products are exact), or the fp32 score f.c - |c|^2/2."""
    x = np.asarray(x4)[:, :N].astype(np.float32)
    c = np.asarray(c4).astype(np.float32)
    if not split:
        return np.einsum("rn,prk->pnk", x.astype(np.float64), c.astype(np.float64))
    xh = _bf16(x)
    xl = _bf16(x - xh.astype(np.float32))
    ch = _bf16(c)
    cl = _bf16(c - ch.astype(np.float32))
    return sum(np.einsum("rn,prk->pnk", a, b) for a, b in ((xh, ch), (xl, ch), (xh, cl)))


def _near_tie(s):
    """(pop, N) bool: the two best distinct scores lie within the relative
    near-tie class (NaN scores left out, exact duplicates tie in every order)."""
    s = np.where(np.isnan(s), -np.inf, s)
    top = s.max(-1)
    second = np.where(s < top[..., None], s, -np.inf).max(-1)
    return top - second <= NEAR_TIE_REL * np.maximum(1.0, np.abs(top))


def _jax_variant(variant, x4, c4, o4, precision="f32x3"):
    kp = c4.shape[-1]
    ushape = {"rowmax": (POP, kp, 1), "foldusage": (POP, kp, 128)}.get(variant, (POP, 1, kp))
    opp, usage = pl.pallas_call(
        kexp.make_kernel(variant, precision),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(PP // BLOCK,),
            in_specs=[
                pl.BlockSpec((4, BLOCK), lambda i, n: (0, i)),
                pl.BlockSpec((POP, 4, kp), lambda i, n: (0, 0, 0)),
                pl.BlockSpec((POP, 4, kp), lambda i, n: (0, 0, 0)),
            ],
            out_specs=[
                pl.BlockSpec((POP, 3, BLOCK), lambda i, n: (0, 0, i)),
                pl.BlockSpec(ushape, lambda i, n: (0, 0, 0)),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((POP, 3, PP), jnp.float32),
            jax.ShapeDtypeStruct(ushape, jnp.float32),
        ],
        interpret=True,
    )(jnp.full((1,), N, jnp.int32), x4, c4, o4)
    usage = np.asarray(usage)
    # per-entry sums of the TPU layouts: (pop, 1, kp), (pop, kp, 1) flags, (pop, kp, 128) lanes
    per_entry = usage[:, 0, :] if ushape[1] == 1 else usage.sum(2)
    return np.asarray(opp)[:, :, :N], per_entry


def _assert_counts_close(got, want, tie):
    assert np.abs(got.astype(np.int64) - want).sum(1).max() <= 2 * tie.sum(1).max()


@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("variant", tk.VARIANTS)
def test_t4_variant_matches_jax(variant, K):
    feats, pals, x4, c4, o4, c4_jax, o4_jax = _inputs(K, K + len(variant))
    j_opp, j_use = _jax_variant(variant, x4, c4_jax, o4_jax)
    j_use = j_use[:, :K]
    x, c, o = convert.probe_operands_from_jax_numpy(np.asarray(x4), np.asarray(c4), np.asarray(o4), n=N)
    opp, usage = (t.numpy() for t in tk.run_variant(variant, x, c, o))
    tie = _near_tie(_scores64(x4, c4_jax, split=True)[..., :K])
    ok = ~tie
    if variant == "dotmax":
        np.testing.assert_array_less(np.abs(opp - j_opp), ROWMAX_RTOL * np.maximum(1.0, np.abs(j_opp)))
    elif variant == "avg":
        for p in range(POP):
            np.testing.assert_allclose(opp[p][:, ok[p]], j_opp[p][:, ok[p]], rtol=0, atol=AVG_ATOL)
        assert (usage.sum(1) >= N).all() and usage[2, 9] == usage[2, 11] > 0  # every tie a hit
    else:
        for p in range(POP):
            np.testing.assert_array_equal(opp[p][:, ok[p]], j_opp[p][:, ok[p]])
    if variant in ("nocounts", "nogather", "dotmax"):
        assert not usage.any() and not j_use.any()
    elif variant == "nowhen":
        # the JAX kernel keeps the last grid block's counts; the port has no
        # grid blocks and returns every pixel's, as `current` counts them
        _assert_counts_close(usage, _jax_variant("current", x4, c4_jax, o4_jax)[1][:, :K], tie)
    else:
        _assert_counts_close(usage, j_use, tie)
    if variant not in ("avg", "rowmax", "nocounts", "nogather", "dotmax"):
        assert (usage.sum(1) == N).all() and usage[1, 7] == 0 and usage[0, 5] == 0


@pytest.mark.parametrize("K", [64, 256])
def test_t4_current_at_highest_runs_b1(K):
    """`current` at precision "highest" is B1's function, fp32."""
    feats, pals, x4, _, _, c4_jax, o4_jax = _inputs(K, 7 * K)
    j_opp, j_use = _jax_variant("current", x4, c4_jax, o4_jax, precision="highest")
    f, p_, o_ = (torch.from_numpy(a) for a in (feats[:N], pals, pals))
    opp, counts = ak.assign_opp_usage_pop(f, p_, o_, precision="highest")
    tie = _near_tie(_scores64(x4, c4_jax, split=False)[..., :K])
    for p in range(POP):
        np.testing.assert_array_equal(opp[p].numpy()[:, ~tie[p]], j_opp[p][:, ~tie[p]])
    _assert_counts_close(counts.numpy(), j_use[:, :K], tie)
    assert counts[1, 7] == 0 and (counts.sum(1) == N).all()


def test_kexp_tool_main_on_the_cpu():
    """The tool's entry point and argv on the CPU at a small frame: every
    variant, and `current` at "highest" through B1."""
    out = tk.main([",".join(tk.VARIANTS), "64"], device="cpu", shape=(8, 16))
    assert sorted(v for _, v in out) == sorted(tk.VARIANTS) and all(r["ms"] > 0 for r in out.values())
    assert list(tk.main(["current", "32", "highest"], device="cpu", shape=(8, 16))) == [(32, "current")]
    with pytest.raises(ValueError):
        tk.main(["avg", "32", "bf16"], device="cpu", shape=(8, 16))
