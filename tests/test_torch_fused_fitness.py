"""The B2 kernel's plain version and the population fitness against the JAX
package: the Pallas fused kernel in interpret mode at "highest", and
`make_population_fitness` with `use_pallas` "on" and "off"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import fused_fitness as jff
from hybridquantization_tpu.ops.band_conv import padded_plan
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.config import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.pipeline import (
    _make_context,
    make_fitness,
    make_population_fitness,
)
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# Both sides compute in f32 with different summation orders: the JAX test
# holds its Pallas path to its plain path at atol 2e-5 on the mean
# (tests/test_pallas_assign.py:303); sums carry the same relative error.
SUM_RTOL = 2e-5
ERR_ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quantized_opp(img, pals):
    """(pop, 3, H, W) quantized opponent images for random palettes."""
    H, W, _ = img.shape
    opp, _ = ak.assign_opp_usage_pop(
        _t(img.reshape(-1, 3)), _t(pals), tcs.srgb_to_opp(_t(pals))
    )
    return opp.reshape(len(pals), 3, H, W).numpy()


@pytest.mark.parametrize("kind", ["CIE76", "CIE94", "CIEDE2000"])
def test_b2_plain_matches_pallas(kind):
    H, W = 140, 200
    rng = np.random.default_rng(11)
    img = rng.random((H, W, 3), dtype=np.float32)
    pals = rng.random((2, 7, 3), dtype=np.float32)
    q = _quantized_opp(img, pals)

    jcfg = JConfig(
        swasa=JSWASA(num_colors=7, population=2), use_pallas="on", deltaE=kind,
        precision="highest",
    )
    jq = JQuantizer(jcfg)
    ctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    Hp, Wp, pad_ok = padded_plan(H, W, jq.filters.half_width)
    assert pad_ok
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W)), mode="symmetric")
    want = np.asarray(
        jff.fused_scielab_err_sums(
            jnp.asarray(q_pad), ctx["target_planar"], ctx["mats_h"], ctx["mats_v"],
            tuple(jcs.WHITEPOINTS["D65"].tolist()), H=H, W=W, deltaE=kind,
            precision="highest", interpret=True,
        )
    )

    f = build_filters()
    target = np.asarray(ctx["target_planar"])[:, :H, :W]
    got = ff.fused_scielab_err_sums(
        _t(q), _t(target), stacked_kernels(f, False), stacked_kernels(f, True),
        tcs.WHITEPOINTS["D65"], kind,
    ).numpy()
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize(
    "bad",
    [
        dict(q=(2, 4, 30, 30)),
        dict(target=(3, 30, 31)),
        dict(kh=(7, 20), kv=(7, 20)),
        dict(kh=(6, 21), kv=(6, 21)),
        dict(q=(2, 3, 10, 30), target=(3, 10, 30)),  # half-width 10 not below H
        dict(kind="CIE2001"),
    ],
)
def test_b2_wrapper_checks_inputs(bad):
    shapes = dict(q=(2, 3, 30, 30), target=(3, 30, 30), kh=(7, 21), kv=(7, 21))
    shapes.update({k: v for k, v in bad.items() if k != "kind"})
    t = {k: torch.zeros(v) for k, v in shapes.items()}
    with pytest.raises(ValueError):
        ff.fused_scielab_err_sums(
            t["q"], t["target"], t["kh"], t["kv"], tcs.WHITEPOINT_D65, bad.get("kind", "CIE76")
        )


@pytest.mark.parametrize(
    "use_pallas,kind,space",
    [("on", "CIE76", "srgb"), ("off", "CIE76", "srgb"), ("off", "CIE94", "lab")],
)
def test_population_fitness_matches_jax(use_pallas, kind, space):
    H, W, K, pop = 140, 150, 6, 3
    rng = np.random.default_rng(12)
    img = rng.random((H, W, 3), dtype=np.float32)
    pals = rng.random((pop, K, 3), dtype=np.float32)
    pals[0, 4] = pals[0, 1]  # a duplicate entry: unused, penalised

    jcfg = JConfig(
        swasa=JSWASA(num_colors=K, population=pop), use_pallas=use_pallas, deltaE=kind,
        assignment_space=space, precision="highest",
    )
    jq = JQuantizer(jcfg)
    jctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    j_err, j_use = jax.jit(j_pop_fitness(jctx, jcfg, jq.filters.half_width))(jnp.asarray(pals))

    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=K, population=pop), deltaE=kind, assignment_space=space,
    )
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    err, use = make_population_fitness(ctx, cfg)(_t(pals))
    np.testing.assert_array_equal(use.numpy(), np.asarray(j_use))
    assert not use[0, 4]
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=0, atol=ERR_ATOL)

    single = make_fitness(ctx, cfg)
    for p in range(pop):
        e, u = single(_t(pals[p]))
        np.testing.assert_array_equal(u.numpy(), use[p].numpy())
        assert float(e) == pytest.approx(float(err[p]), rel=1e-5)


def test_context_target_matches_jax():
    H, W = 50, 60
    img = np.random.default_rng(13).random((H, W, 3), dtype=np.float32)
    jcfg = JConfig(use_pallas="off")
    jq = JQuantizer(jcfg)
    jctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    ctx = _make_context(img, build_filters(), QuantizationConfig(), "cpu")
    np.testing.assert_allclose(
        ctx["target_lab"].numpy(), np.asarray(jctx["target_lab"]), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_array_equal(
        ctx["target_planar"].numpy(), np.moveaxis(ctx["target_lab"].numpy(), -1, 0)
    )


def test_fused_plan_takes_the_fused_kernel_for_the_default_filter():
    taps = build_filters().half_width * 2 + 1
    assert taps == ff.DEFAULT_TAPS
    plan = ff.fused_plan(2160, 3840, taps)
    assert plan["path"] == "fused" and plan["rows_per_block"] % ff.TILE_H == 0
    assert plan["partials"] == 120 * -(-2160 // plan["rows_per_block"])
    # two blocks fit an SM's 228 KB (each with its 1 KB reserve)
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    # a short image takes one segment of its height rounded up to 32 rows
    assert ff.fused_plan(11, 300, taps) == {**plan, "rows_per_block": 32, "partials": 10}


@pytest.mark.parametrize("taps", [1, 3, 21, 23, 63, 95, 97, 99, 101, 1025])
def test_fused_plan_switches_to_two_passes_above_the_tap_limit(taps):
    plan = ff.fused_plan(1080, 1920, taps)
    if taps <= ff.MAX_FUSED_TAPS:
        assert plan["path"] == "fused" and plan["smem_bytes"] <= ff.SMEM_LIMIT
    else:
        assert plan == {"path": "two_pass", "rows_per_block": 0, "smem_bytes": 28 * taps,
                        "partials": 8 * 1080}
    # the limit is the largest odd filter whose ring and staging buffers fit
    assert ff.fused_smem_bytes(ff.MAX_FUSED_TAPS) <= ff.SMEM_LIMIT < ff.fused_smem_bytes(ff.MAX_FUSED_TAPS + 2)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_taps_hold_the_default_stacks_once_in_the_context(bf16):
    """The fused kernel's coefficient parameter at 21 taps: kh then kv,
    rounded to bf16 in bf16 mode, made once by the context; other filters
    have none (their coefficients go through shared memory)."""
    f = build_filters()
    kh, kv = stacked_kernels(f, False), stacked_kernels(f, True)
    got = ff.kernel_taps(kh, kv)[bf16]
    want = torch.stack([kh, kv])
    want = ak.bf16_round(want) if bf16 else want
    assert torch.equal(torch.tensor(list(got)).reshape(2, 7, 21), want)
    ctx = _make_context(np.zeros((24, 24, 3), np.float32), f, QuantizationConfig(), "cpu")
    assert list(ctx["taps_on_host"][bf16]) == list(got)
    wide = build_filters(150, 45.0)
    assert ff.kernel_taps(stacked_kernels(wide, False), stacked_kernels(wide, True)) is None


def test_fused_plan_mirrors_the_kernels_shared_layout():
    """fused_smem_bytes is csrc/fused_fitness.cu's layout: at 21 taps one
    staging buffer of 3 x 32 rows x (32 + 2 x 12) columns and a ring of 2 x
    32 + 20 rows of 7 x 32 floats (no stacks: the coefficients are a kernel
    parameter); at other taps two buffers, 1 + ceil((taps - 1) / 32) ring
    groups and the stacks, the horizontal one with lead - half zeros first.
    Two blocks of the default layout fit an SM."""
    assert ff.fused_smem_bytes(21) == 4 * (3 * 32 * 56 + 84 * 7 * 32)
    assert 2 * (ff.fused_smem_bytes(21) + 1024) <= 228 * 1024
    half, lead = 14, 16  # 29 taps
    assert ff.fused_smem_bytes(29) == 4 * (2 * 3 * 32 * (32 + 2 * lead) + 2 * 32 * 7 * 32 + 8 * (2 * 29 + lead - half))
    # at MAX_FUSED_TAPS a staged row is 128 columns, the 32 16-byte chunks
    # that the kernel's staging gives a lane each (kMaxStageWidth)
    assert ff.fused_smem_bytes(97) == 4 * (2 * 3 * 32 * 128 + 4 * 32 * 7 * 32 + 8 * 2 * 97)
