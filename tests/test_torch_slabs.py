"""B2s, the B2 kernel with column guards (`fused_scielab_err_sums(...,
left_slab=, right_slab=)`), and the column plan of the port's parallel.fast,
on the CPU: the plain version against JAX's `edges="slabs"` Pallas kernel
(interpret mode, "highest") shard by shard on JAX's own column split, and
the shards' sums against the whole image's. One rank, no process group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import fused_fitness as jff
from hybridquantization_tpu.parallel import fast as j_fast
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.parallel import ShardedBatchQuantizer, make_mesh, plan_fast
from hybridquantization_tpu_torch.parallel.fast import _column_guards, build_sharded_fast_fns
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# B2's sums against JAX's at "highest" and a shard's against the whole
# image's: f32 filters and Delta-E in other summation orders
SUM_RTOL = 1e-5
H, W, POP, K = 72, 300, 2, 7
HALF = build_filters().half_width


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def frame():
    """(quantized opponent images (pop, 3, H, W), image) for random palettes."""
    rng = np.random.default_rng(21)
    img = rng.random((H, W, 3), dtype=np.float32)
    pals = rng.random((POP, K, 3), dtype=np.float32)
    opp, _ = ak.assign_opp_usage_pop(_t(img.reshape(-1, 3)), _t(pals), tcs.srgb_to_opp(_t(pals)))
    return opp.reshape(POP, 3, H, W).numpy(), img


def _kernels():
    f = build_filters()
    return stacked_kernels(f, False), stacked_kernels(f, True)


def _shard(q, target, lo, hi, kind="CIE76", precision="f32x3"):
    """The port's B2s sums of columns [lo, hi): guards from the columns
    beyond, mirrored where a border of the image lies."""
    qt = _t(q)
    left = qt[..., lo - HALF:lo] if lo else qt[..., :HALF].flip(-1)
    right = qt[..., hi:hi + HALF] if hi < q.shape[-1] else qt[..., hi - HALF:hi].flip(-1)
    kh, kv = _kernels()
    return ff.fused_scielab_err_sums(
        qt[..., lo:hi], _t(target)[..., lo:hi], kh, kv, tcs.WHITEPOINT_D65, kind, precision=precision,
        left_slab=left, right_slab=right,
    ).numpy()


@pytest.mark.parametrize("kind", ["CIE76", "CIE94", "CIEDE2000"])
def test_slabs_plain_matches_pallas_per_shard(frame, kind):
    """JAX's split of W=300 over 2 shards: shard 0 holds columns 0-255,
    shard 1 columns 256-299 and a masked pad; the port gets the same two
    ranges, its guards from the neighbour or mirrored."""
    q, img = frame
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=POP), use_pallas="on", deltaE=kind, precision="highest")
    jq = JQuantizer(jcfg)
    ctx = j_make_context(jnp.asarray(img), jq.filters, jcfg)
    Hp, Wt, Ws, ok = j_fast.plan_fast(H, W, jq.filters.half_width, 2)
    assert ok and (Ws, Wt) == (256, 512)
    target = np.asarray(ctx["target_planar"])[:, :H, :W]
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, Hp - H), (0, Wt - W)), mode="symmetric")
    t_pad = np.zeros((3, Hp, Wt), np.float32)
    t_pad[:, :H, :W] = target
    B = jff.BLOCK
    for s in range(2):
        qs = q_pad[..., s * Ws:(s + 1) * Ws]
        left = qs[..., :B][..., ::-1] if s == 0 else q_pad[..., s * Ws - B:s * Ws]
        right = qs[..., -B:][..., ::-1] if s == 1 else q_pad[..., (s + 1) * Ws:(s + 1) * Ws + B]
        want = np.asarray(jff.fused_scielab_err_sums(
            jnp.asarray(qs), jnp.asarray(t_pad[..., s * Ws:(s + 1) * Ws]), ctx["mats_h"], ctx["mats_v"],
            tuple(jcs.WHITEPOINTS["D65"].tolist()), hw=jnp.asarray([H, min(W - s * Ws, Ws)]), deltaE=kind,
            precision="highest", interpret=True, edges="slabs",
            left_slab=jnp.asarray(np.ascontiguousarray(left)), right_slab=jnp.asarray(np.ascontiguousarray(right)),
        ))
        got = _shard(q, target, s * Ws, min((s + 1) * Ws, W), kind)
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize(
    "kind,precision", [("CIE76", "f32x3"), ("CIE94", "f32x3"), ("CIEDE2000", "f32x3"), ("CIE76", "bf16")]
)
def test_shard_sums_add_up_to_the_whole_image(frame, kind, precision):
    """The port's plan over 3 shards: their sums add up to mirror B2's."""
    q, img = frame
    target = np.random.default_rng(22).random((3, H, W), dtype=np.float32) * 60
    kh, kv = _kernels()
    whole = ff.fused_scielab_err_sums(_t(q), _t(target), kh, kv, tcs.WHITEPOINT_D65, kind, precision=precision)
    cols, ok = plan_fast(H, W, HALF, 3)
    assert ok and cols == ((0, 100), (100, 200), (200, 300))
    parts = [_shard(q, target, lo, hi, kind, precision) for lo, hi in cols]
    np.testing.assert_allclose(np.sum(parts, axis=0, dtype=np.float64), whole.numpy(), rtol=SUM_RTOL)


@pytest.mark.parametrize("precision", ["f32x3", "bf16"])
def test_mirrored_guards_equal_mirror_mode(frame, precision):
    """Guards mirrored at both borders of the whole image read the samples
    mirror B2 reads, in the same order: bit-equal sums."""
    q, _ = frame
    target = np.random.default_rng(23).random((3, H, W), dtype=np.float32) * 60
    kh, kv = _kernels()
    want = ff.fused_scielab_err_sums(_t(q), _t(target), kh, kv, tcs.WHITEPOINT_D65, precision=precision)
    got = _shard(q, target, 0, W, precision=precision)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize(
    "guards",
    [dict(left=(2, 3, 30, 10)), dict(left=(2, 3, 30, 9), right=(2, 3, 30, 9)),
     dict(left=(2, 3, 29, 10), right=(2, 3, 29, 10))],
    ids=["one_guard", "narrow", "short"],
)
def test_slab_wrapper_checks_guards(guards):
    kh, kv = _kernels()
    slabs = {f"{k}_slab": torch.zeros(v) for k, v in guards.items()}
    with pytest.raises(ValueError, match="slab"):
        ff.fused_scielab_err_sums(torch.zeros(2, 3, 30, 30), torch.zeros(3, 30, 30), kh, kv,
                                  tcs.WHITEPOINT_D65, **slabs)


def test_guards_allow_a_shard_narrower_than_the_filter():
    """Without guards B2 needs W above the half-width; a shard of 4 columns
    takes its context from the guards."""
    q = np.random.default_rng(24).random((1, 3, 30, 4 + 2 * HALF), dtype=np.float32)
    target = np.random.default_rng(25).random((3, 30, 4 + 2 * HALF), dtype=np.float32)
    got = _shard(q, target, HALF, HALF + 4)
    assert got.shape == (1,) and np.isfinite(got).all()


@pytest.mark.parametrize(
    "h,w,n,cols,ok",
    [
        (72, 300, 2, ((0, 150), (150, 300)), True),
        (72, 31, 3, ((0, 11), (11, 21), (21, 31)), True),
        (72, 29, 3, ((0, 10), (10, 20), (20, 29)), False),
        (10, 300, 2, ((0, 150), (150, 300)), False),
        (72, 10, 1, ((0, 10),), False),
        (72, 11, 1, ((0, 11),), True),
    ],
)
def test_plan_fast(h, w, n, cols, ok):
    """Contiguous ranges as equal as possible, no padding; infeasible when
    a shard is narrower than the half-width (10) or H is not above it."""
    assert plan_fast(h, w, HALF, n) == (cols, ok)


def test_column_guards_mirror_on_one_rank():
    q = torch.arange(2 * 3 * 4 * 25, dtype=torch.float32).reshape(2, 3, 4, 25)
    left, right = _column_guards(q, HALF, make_mesh(device="cpu"))
    assert torch.equal(left, q[..., :HALF].flip(-1)) and torch.equal(right, q[..., -HALF:].flip(-1))


def test_columns_strategy_names_its_infeasibility():
    q = ShardedBatchQuantizer(QuantizationConfig(swasa=SWASAConfig(imax=1)), make_mesh(device="cpu"),
                              strategy="columns")
    with pytest.raises(ValueError, match="columns strategy infeasible for 40x8 over 1 shards"):
        q.find_palettes(np.zeros((1, 40, 8, 3), np.float32))
    with pytest.raises(ValueError, match="unknown strategy"):
        ShardedBatchQuantizer(QuantizationConfig(), make_mesh(device="cpu"), strategy="tiles")


def test_fast_engine_names_an_unsupported_delta_e():
    cfg = QuantizationConfig()
    object.__setattr__(cfg, "deltaE", "CIE2001")  # past the config's own check
    with pytest.raises(ValueError, match="deltaE 'CIE2001' not supported by the fused kernel"):
        build_sharded_fast_fns(make_mesh(device="cpu"), cfg, build_filters())
