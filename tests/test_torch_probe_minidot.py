"""The port's split-bf16 kernels on dense and per-run candidates (T5–T8)
against the JAX package's probe `tools/minidot_probe.py`, whose kernels read
the module globals BLOCK, POP and KC at trace time: each test patches BLOCK
to 1024 and builds the probe's pallas_call with its BlockSpecs and
interpret=True on 2 blocks, pop 4, KC 64, x and candidates random in all 4
rows (the probe takes no n: every pixel is valid). The per-run candidate
sets of one block, which every block reuses, go through
`convert.probe_operands_from_jax_numpy` to the port's (pop, P / run, 4, KC)."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hybridquantization_tpu_torch import convert
from hybridquantization_tpu_torch.ops import probe_kernels as pk
from hybridquantization_tpu_torch.tools import minidot_probe as tm

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parent.parent
BLOCK = 1024
PP = 2 * BLOCK
NEAR_TIE_REL = 1e-6  # |top-2 score gap| <= this * max(1, |score|): f32 may pick either
ROWMAX_RTOL = 1e-6


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mini = _load("minidot_probe")
POP, KC = mini.POP, mini.KC


@pytest.fixture(autouse=True)
def small_block(monkeypatch):
    monkeypatch.setattr(mini, "BLOCK", BLOCK)


def _inputs(seed, run):
    """x (4, PP) and one block's candidate sets (pop, BLOCK / run, 4, KC),
    with an exact duplicate candidate in every set."""
    rng = np.random.default_rng(seed)
    x = rng.random((4, PP), dtype=np.float32)
    c = rng.random((POP, BLOCK // run, 4, KC), dtype=np.float32)
    c[:, :, :, 5] = c[:, :, :, 2]
    return x, c


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).to(torch.float64).numpy()


def _scores64(x, c):
    """(pop, P, Kc) exact f64 split-bf16 scores; c (pop, 4, K) or the port's
    per-run (pop, R, 4, KC)."""
    xh = _bf16(x)
    xl = _bf16(x - xh.astype(np.float32))
    ch = _bf16(c)
    cl = _bf16(c - ch.astype(np.float32))
    if c.ndim == 3:
        return sum(np.einsum("rn,prk->pnk", a, b) for a, b in ((xh, ch), (xl, ch), (xh, cl)))
    R = c.shape[1]
    run = x.shape[1] // R

    def dot(a, b):
        return np.einsum("rqn,pqrk->pqnk", a.reshape(4, R, run), b).reshape(POP, -1, b.shape[-1])

    return dot(xh, ch) + dot(xl, ch) + dot(xh, cl)


def _near_tie(s):
    s = np.where(np.isnan(s), -np.inf, s)
    top = s.max(-1)
    second = np.where(s < top[..., None], s, -np.inf).max(-1)
    return top - second <= NEAR_TIE_REL * np.maximum(1.0, np.abs(top))


def _rowmax_jax(kernel, x, c):
    return np.asarray(pl.pallas_call(
        kernel, grid=(PP // BLOCK,),
        in_specs=[pl.BlockSpec((4, BLOCK), lambda i: (0, i)),
                  pl.BlockSpec(c.shape, lambda i: (0,) * c.ndim)],
        out_specs=pl.BlockSpec((POP, BLOCK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((POP, PP), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(c)))


def _full_jax(kernel, x, c, scratch=()):
    opp, use = pl.pallas_call(
        kernel, grid=(PP // BLOCK,),
        in_specs=[pl.BlockSpec((4, BLOCK), lambda i: (0, i)),
                  pl.BlockSpec(c.shape, lambda i: (0, 0, 0, 0)),
                  pl.BlockSpec(c.shape, lambda i: (0, 0, 0, 0))],
        out_specs=[pl.BlockSpec((POP, 3, BLOCK), lambda i: (0, 0, i)),
                   pl.BlockSpec((POP, KC, 128), lambda i: (0, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((POP, 3, PP), jnp.float32),
                   jax.ShapeDtypeStruct((POP, KC, 128), jnp.float32)],
        scratch_shapes=list(scratch),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(c), jnp.asarray(c))
    return np.asarray(opp), np.asarray(use).sum(2).astype(np.int64)


def _assert_rowmax_close(got, want):
    np.testing.assert_array_less(np.abs(got - want), ROWMAX_RTOL * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("K", [64, 256])
def test_t5_dense_rowmax_matches_jax(K):
    rng = np.random.default_rng(K)
    x = rng.random((4, PP), dtype=np.float32)
    c = rng.random((POP, 4, K), dtype=np.float32)
    want = _rowmax_jax(mini._dense_kernel, x, c)
    xt, ct, _ = convert.probe_operands_from_jax_numpy(x, c)
    assert ct.shape == (POP, 4, K)  # row 3 is random, not a bias: nothing is dropped
    _assert_rowmax_close(pk.split_rowmax(xt, ct).numpy(), want)


@pytest.mark.parametrize("run", [128, 256])
def test_t6_per_run_rowmax_matches_jax(run):
    x, c = _inputs(run, run)
    want = _rowmax_jax(functools.partial(mini._mini_kernel, run=run), x, c)
    xt, ct, _ = convert.probe_operands_from_jax_numpy(x, c, block=BLOCK)
    assert ct.shape == (POP, PP // run, 4, KC)
    assert torch.equal(ct[:, BLOCK // run], ct[:, 0])  # block 1 reuses block 0's sets
    _assert_rowmax_close(pk.split_rowmax(xt, ct, run=run).numpy(), want)


def _check_full(x, c, opp, counts, idx, j_opp, run):
    """Colours equal off the near-tie class; returns the near-tie mask."""
    tie = _near_tie(_scores64(x, c.numpy()))
    for p in range(POP):
        np.testing.assert_array_equal(opp[p][:, ~tie[p]], j_opp[p][:, ~tie[p]])
    assert (counts.sum(1) == PP).all()  # the port counts every pixel
    for p in range(POP):
        assert np.array_equal(counts[p], np.bincount(idx[p], minlength=KC))
    assert counts[:, 5].sum() == 0  # the duplicate of candidate 2 never wins
    return tie


@pytest.mark.parametrize("run", [128, 256])
def test_t7_minifull_matches_jax(run):
    x, c = _inputs(3 * run, run)
    j_opp, j_use = _full_jax(functools.partial(mini._mini_full_kernel, run=run), x, c)
    xt, ct, ot = convert.probe_operands_from_jax_numpy(x, c, c, block=BLOCK)
    opp, counts, idx = (t.numpy() for t in pk.split_assign(xt, ct, ot, run=run, opp_parts=2,
                                                           return_index=True))
    tie = _check_full(x, ct, opp, counts, idx, j_opp, run)
    # JAX stores acc[:, :128]: at run 256 the counts of each run's first 128
    # pixels only; the port's, restricted there through the index
    first = (np.arange(PP) % run) < 128
    part = np.stack([np.bincount(idx[p][first], minlength=KC) for p in range(POP)])
    assert np.abs(part - j_use).sum(1).max() <= 2 * (tie & first).sum(1).max()


@pytest.mark.parametrize("run", [128, 256])
def test_t8_minifull2_matches_jax(run):
    x, c = _inputs(5 * run, run)
    j_opp, j_use = _full_jax(functools.partial(mini._mini_full2_kernel, run=run), x, c,
                             scratch=[pltpu.VMEM((KC, BLOCK), jnp.float32)])
    xt, ct, ot = convert.probe_operands_from_jax_numpy(x, c, c, block=BLOCK)
    opp, counts, idx = (t.numpy() for t in pk.split_assign(xt, ct, ot, run=run, opp_parts=2,
                                                           return_index=True))
    tie = _check_full(x, ct, opp, counts, idx, j_opp, run)
    assert np.abs(counts - j_use).sum(1).max() <= 2 * tie.sum(1).max()


def test_nan_candidate_never_wins():
    """A NaN candidate never wins in the port; in JAX's kernel it would make
    the max NaN, so JAX gets it as a candidate of -1e30 (never the max on
    x >= 0) and both must agree."""
    run = 128
    x, c = _inputs(11, run)
    c[1, :, :, 9] = -1e30
    c_jax = c.copy()
    c[1, :, 0, 9] = np.nan
    j_opp, _ = _full_jax(functools.partial(mini._mini_full_kernel, run=run), x, c_jax)
    xt, ct, ot = convert.probe_operands_from_jax_numpy(x, c, c, block=BLOCK)
    opp, counts, idx = (t.numpy() for t in pk.split_assign(xt, ct, ot, run=run, opp_parts=2,
                                                           return_index=True))
    c_finite = convert.probe_operands_from_jax_numpy(x, c_jax, block=BLOCK)[1]
    _check_full(x, c_finite, opp, counts, idx, j_opp, run)
    assert counts[1, 9] == 0 and not np.isnan(pk.split_rowmax(xt, ct, run=run).numpy()).any()


def test_minidot_tool_main_on_the_cpu():
    which = ["dense", "mini128", "mini256", "minifull128", "minifull256", "minifull2_128",
             "minifull2_256"]
    out = tm.main(which, device="cpu", shape=(8, 64))
    assert list(out) == which and all(r["ms"] > 0 for r in out.values())
