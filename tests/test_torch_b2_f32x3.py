"""B2's split mode (precision "split", the TPU kernel's f32x3 conv) and the
whole emulated TPU fitness against the JAX package on the CPU.

JAX's fused kernel runs in interpret mode at precision "f32x3": on the CPU
its DEFAULT dots compute in f32, and the kernel itself splits each operand
into bf16 hi and lo and stores the horizontal pass's output as a bf16 pair
(`hybridquantization_tpu/ops/fused_fitness.py:369-393`, `:415-424`), so
interpret mode computes the TPU's function. Every comparison also holds the
port's fp32 mode at least TEETH times farther from JAX's f32x3 than the
split mode's tolerance, so a split mode that did nothing would fail.

Also: the fingerprint's log parser (`chip_c2.parse_gaps`,
`fingerprint_table`) on the TPU's layer-2 logs as they are, and the
fingerprint stage and the f32x3 banks of `chip_c2.py` rehearsed at a tiny
size."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import HybridQuantizer as JQuantizer
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import colorspace as jcs
from hybridquantization_tpu.ops import fused_fitness as jff
from hybridquantization_tpu.ops.band_conv import padded_plan
from hybridquantization_tpu.parallel import fast as j_fast
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import colorspace as tcs
from hybridquantization_tpu_torch.ops import assign_kernel as ak
from hybridquantization_tpu_torch.ops import fused_fitness as ff
from hybridquantization_tpu_torch.pipeline import _make_context
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.scielab.transform import stacked_kernels
from hybridquantization_tpu_torch.tools import tpu_f32x3

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

# B2's split mode against JAX's f32x3 kernel, relative, on Delta-E sums: the
# same exact products summed in another f32 order (measured 1.2e-7 to
# 2.3e-7 here; the fp32 mode sits 1.4e-6 to 2.4e-6 away)
SPLIT_RTOL = 4e-7
# the whole emulated fitness (split_assign, then B2's split mode) against
# JAX's Pallas-branch f32x3 fitness, relative: 2.2e-7 measured on this
# test's draw, where the emulation with fp32 B2 sits 2.8e-6 away
# (tests/test_torch_tpu_f32x3.py holds that one at 2e-5)
FITNESS_RTOL = 6e-7
# the fp32 mode must miss JAX's f32x3 by at least this many tolerances
TEETH = 3

H, W, POP, K = 140, 200, 2, 7
KINDS = ["CIE76", "CIE94", "CIEDE2000"]
# the edge checks: the sums over the first EDGE columns (or rows), where
# JAX's kernel multiplies the clamped edge block by its R-folded matrices
EDGE = 12


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) / np.asarray(want, np.float64) - 1)))


@pytest.fixture(scope="module")
def frame():
    """(quantized opponent images (pop, 3, H, W), image) for random palettes."""
    rng = np.random.default_rng(11)
    img = rng.random((H, W, 3), dtype=np.float32)
    pals = rng.random((POP, K, 3), dtype=np.float32)
    opp, _ = ak.assign_opp_usage_pop(_t(img.reshape(-1, 3)), _t(pals), tcs.srgb_to_opp(_t(pals)))
    return opp.reshape(POP, 3, H, W).numpy(), img


def _kernels():
    f = build_filters()
    return stacked_kernels(f, False), stacked_kernels(f, True)


def _jax(img, kind):
    """JAX's context at f32x3 and its padded plan: (ctx, Hp, Wp)."""
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=POP), use_pallas="on", deltaE=kind, precision="f32x3")
    jq = JQuantizer(jcfg)
    Hp, Wp, ok = padded_plan(H, W, jq.filters.half_width)
    assert ok
    return j_make_context(jnp.asarray(img), jq.filters, jcfg), Hp, Wp


def _jax_sums(q, ctx, Hp, Wp, kind, h=H, w=W):
    """JAX's fused kernel at f32x3 (interpret mode) over the valid region
    h x w of the padded image: its mask keeps rows < h and columns < w."""
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, Hp - H), (0, Wp - W)), mode="symmetric")
    return np.asarray(jff.fused_scielab_err_sums(
        jnp.asarray(q_pad), ctx["target_planar"], ctx["mats_h"], ctx["mats_v"],
        tuple(jcs.WHITEPOINTS["D65"].tolist()), H=h, W=w, deltaE=kind, precision="f32x3", interpret=True,
    ))


def _assert_split_close_fp32_far(split, fp32, want, rtol):
    assert _rel(split, want) <= rtol, (_rel(split, want), rtol)
    assert _rel(fp32, want) >= TEETH * rtol, (_rel(fp32, want), TEETH * rtol)


@pytest.mark.parametrize("kind", KINDS)
def test_split_plain_matches_jax_f32x3_kernel(frame, kind):
    q, img = frame
    ctx, Hp, Wp = _jax(img, kind)
    want = _jax_sums(q, ctx, Hp, Wp, kind)
    kh, kv = _kernels()
    target = _t(np.asarray(ctx["target_planar"])[:, :H, :W])
    got = {p: ff.fused_scielab_err_sums(_t(q), target, kh, kv, tcs.WHITEPOINT_D65, kind, precision=p).numpy()
           for p in ("split", "f32x3")}
    assert got["split"].shape == (POP,) and got["split"].dtype == np.float32
    _assert_split_close_fp32_far(got["split"], got["f32x3"], want, SPLIT_RTOL)


@pytest.mark.parametrize("edge", ["left", "top"])
def test_split_plain_matches_jax_at_the_mirror_edges(frame, edge):
    """The sums over the first EDGE columns (or rows) alone: there JAX's
    kernel multiplies the clamped edge block by reversed taps through its
    R-folded matrices, the port reflects by index, product by product."""
    q, img = frame
    ctx, Hp, Wp = _jax(img, "CIE76")
    h, w = (H, EDGE) if edge == "left" else (EDGE, W)
    want = _jax_sums(q, ctx, Hp, Wp, "CIE76", h, w)
    kh, kv = _kernels()
    target = _t(np.asarray(ctx["target_planar"])[:, :H, :W])
    got = {p: ff.delta_e_reference(_t(q), target, kh, kv, tcs.WHITEPOINT_D65, precision=p)[:, :h, :w]
           .double().sum(dim=(1, 2)).numpy() for p in ("split", "f32x3")}
    _assert_split_close_fp32_far(got["split"], got["f32x3"], want, SPLIT_RTOL)


def test_split_plain_matches_jax_slabs_per_shard(frame):
    """B2s in split mode against JAX's edges="slabs" kernel at f32x3, shard
    by shard on JAX's own column split of W=200 over 2 shards."""
    q, img = frame
    ctx, _, _ = _jax(img, "CIE76")
    half = build_filters().half_width
    Hp, Wt, Ws, ok = j_fast.plan_fast(H, W, half, 2)
    assert ok
    target = np.asarray(ctx["target_planar"])[:, :H, :W]
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, Hp - H), (0, Wt - W)), mode="symmetric")
    t_pad = np.zeros((3, Hp, Wt), np.float32)
    t_pad[:, :H, :W] = target
    B = jff.BLOCK
    kh, kv = _kernels()
    qt = _t(q)
    for s in range(2):
        qs = q_pad[..., s * Ws:(s + 1) * Ws]
        left = qs[..., :B][..., ::-1] if s == 0 else q_pad[..., s * Ws - B:s * Ws]
        right = qs[..., -B:][..., ::-1] if s == 1 else q_pad[..., (s + 1) * Ws:(s + 1) * Ws + B]
        want = np.asarray(jff.fused_scielab_err_sums(
            jnp.asarray(qs), jnp.asarray(t_pad[..., s * Ws:(s + 1) * Ws]), ctx["mats_h"], ctx["mats_v"],
            tuple(jcs.WHITEPOINTS["D65"].tolist()), hw=jnp.asarray([H, min(W - s * Ws, Ws)]),
            precision="f32x3", interpret=True, edges="slabs",
            left_slab=jnp.asarray(np.ascontiguousarray(left)), right_slab=jnp.asarray(np.ascontiguousarray(right)),
        ))
        lo, hi = s * Ws, min((s + 1) * Ws, W)
        guards = {"left_slab": qt[..., lo - half:lo] if lo else qt[..., :half].flip(-1),
                  "right_slab": qt[..., hi:hi + half] if hi < W else qt[..., hi - half:hi].flip(-1)}
        got = {p: ff.fused_scielab_err_sums(qt[..., lo:hi].contiguous(), _t(target[..., lo:hi]), kh, kv,
                                            tcs.WHITEPOINT_D65, precision=p,
                                            **{k: v.contiguous() for k, v in guards.items()}).numpy()
               for p in ("split", "f32x3")}
        _assert_split_close_fp32_far(got["split"], got["f32x3"], want, SPLIT_RTOL)


def test_split_image_axis_runs_each_image_on_its_own(frame):
    q, img = frame
    kh, kv = _kernels()
    target = tcs.srgb_to_lab(_t(img)).movedim(-1, 0).contiguous()
    qb, tb = torch.stack([_t(q), _t(q[::-1])]), torch.stack([target, target])
    got = ff.fused_scielab_err_sums(qb, tb, kh, kv, tcs.WHITEPOINT_D65, precision="split")
    for i in range(2):
        assert torch.equal(got[i], ff.fused_scielab_err_sums(qb[i], tb[i], kh, kv, tcs.WHITEPOINT_D65,
                                                             precision="split"))


def test_split_taps_and_the_cpu_wrapper():
    """The split's taps as the tensor-core kernel's band tables hold them:
    the stacks' hi = bf16(x), as its core and its tail, and lo = bf16(x -
    hi); kernel_taps' [False] and [True] still pick fp32 and bf16. On the
    CPU the wrapper runs the plain version and counts no launch."""
    kh, kv = _kernels()
    taps = ff.kernel_taps(kh, kv)
    stacks = torch.stack([kh, kv])
    # row 0 of a band's core matrix on diagonal 0 holds taps 0..7: core, tail, lo
    split = torch.stack([ff.band_cores(s, 3, 2).float()[:, :, 2, 0] for s in stacks])
    assert torch.equal(split[:, :, 0] + split[:, :, 1], ak.bf16_round(stacks[..., :8]))
    assert torch.equal(split[:, :, 2], ak.bf16_round(stacks[..., :8] - split[:, :, 0] - split[:, :, 1]))
    hi, lo = ff.split_bf16(stacks)
    normal = stacks.abs() > 1e-30  # a bf16 split of an f32 subnormal keeps what bf16 can hold
    assert (lo != 0).any()
    assert ((hi + lo - stacks).abs() <= 2**-16 * stacks.abs())[normal].all()
    assert list(taps[False]) == list(taps[0]) and list(taps[True]) == list(taps[1])
    before = (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.split_launches)
    q = torch.rand((2, 3, 24, 30), generator=torch.Generator().manual_seed(3))
    target = torch.rand((3, 24, 30), generator=torch.Generator().manual_seed(4)) * 50
    got = ff.fused_scielab_err_sums(q, target, kh, kv, tcs.WHITEPOINT_D65, precision="split")
    assert torch.equal(got, ff.fused_scielab_err_sums_reference(q, target, kh, kv, tcs.WHITEPOINT_D65,
                                                                precision="split"))
    assert (ff.fused_scielab_err_sums.launches, ff.fused_scielab_err_sums.split_launches) == before
    with pytest.raises(ValueError):
        ff.fused_scielab_err_sums(q, target, kh, kv, tcs.WHITEPOINT_D65, precision="f32x4")


def test_whole_emulated_fitness_matches_jax_pallas_branch():
    """conv "split": split_assign at f32x3, then B2's split mode, against
    JAX's Pallas-branch population fitness at precision "f32x3" (its
    assignment kernel and its fused kernel in interpret mode)."""
    h, w, k, pop = 64, 80, 16, 4
    rng = np.random.default_rng(0)
    img = rng.random((h, w, 3), dtype=np.float32)
    pals = rng.random((pop, k, 3), dtype=np.float32)
    pals[:, 5] = pals[:, 2]  # duplicates: unused, penalised
    jcfg = JConfig(swasa=JSWASA(num_colors=k, population=pop), use_pallas="on", precision="f32x3")
    jq = JQuantizer(jcfg)
    j_err, j_use = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg,
                                 jq.filters.half_width)(jnp.asarray(pals))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=k, population=pop))
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    got = {}
    for conv in tpu_f32x3.CONVS:
        err, use = tpu_f32x3.make_split_population_fitness(ctx, cfg, conv)(_t(pals))
        np.testing.assert_array_equal(use.numpy(), np.asarray(j_use))
        got[conv] = err.numpy()
    _assert_split_close_fp32_far(got["split"], got["fp32"], np.asarray(j_err), FITNESS_RTOL)
    with pytest.raises(ValueError):
        tpu_f32x3.make_split_population_fitness(ctx, cfg, "bf16")


# ---- the fingerprint (chip_c2.py) ----

TPU_LOGS = {"config1": ("fitness_parity_config1_r04.log", 8),
            "config2": ("fitness_parity_config2_r04.log", 12),
            "config2nat": ("fitness_parity_config2nat_r05.log", 12)}


@pytest.mark.parametrize("name", list(TPU_LOGS))
def test_fingerprint_parser_reads_the_tpu_logs(name):
    import os

    import chip_c2

    log, batches = TPU_LOGS[name]
    path = os.path.join(chip_c2.EVIDENCE, log)
    gaps = chip_c2.parse_gaps(path)
    assert sorted(gaps) == [(b, m) for b in range(batches) for m in range(4)]
    text, stats = chip_c2.fingerprint_table(name, path, {"tpu": path, "split": os.path.join(
        chip_c2.C2, f"fitness_parity_split_{name}.log")})
    assert stats["tpu"] == (0.0, 0.0)  # the log against itself
    assert f"; {4 * (batches - 1)} palettes" in text.splitlines()[0]  # the tie-stress batch left out
    rows = [ln for ln in text.splitlines()[2:-1]]
    assert len(rows) == 4 * (batches - 1) and not any(ln.split()[0] == "0" for ln in rows)


def test_fingerprint_parser_values():
    import os

    import chip_c2

    gaps = chip_c2.parse_gaps(os.path.join(chip_c2.EVIDENCE, "fitness_parity_config1_r04.log"))
    assert gaps[(0, 1)] == 7.66e-02 and gaps[(4, 0)] == 2.43e-05 and gaps[(7, 3)] == 7.53e-07
    # the split-assignment logs (docs/evidence_h100/c2/) against the TPU's, recomputed
    _, stats = chip_c2.fingerprint_table(
        "config1", os.path.join(chip_c2.EVIDENCE, "fitness_parity_config1_r04.log"),
        {"split": os.path.join(chip_c2.C2, "fitness_parity_split_config1.log")})
    assert f"{stats['split'][0]:.3e} {stats['split'][1]:.3e}" == "1.132e-05 1.990e-06"


def test_chip_c2_fingerprint_and_f32x3_banks_rehearse_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_c2's fingerprint stage (layer 2 with conv split, then the table
    against a stand-in TPU log), the f32x3 bank through chip_draws
    (`--fitness f32x3`), its pairing with the JAX bank, and a
    rerun bank held bit for bit to the bank it repeats."""
    import chip_c2
    import chip_draws
    from hybridquantization_tpu_torch.tools import engine_run

    size, k, imax = 32, 4, 12
    evidence, h100, out = tmp_path / "evidence", tmp_path / "h100", tmp_path / "c2"
    for d in (evidence, h100, out):
        d.mkdir()
    cfg = {"size": size, "colors": k, "imax": imax, "population": 4, "content": "natural"}
    (evidence / "jax.jsonl").write_text("".join(
        json.dumps({"seed": s, "deltaE": 22.0 + s, "mse": 0.03, **cfg}) + "\n" for s in range(3)))
    (evidence / "oracle.jsonl").write_text("".join(
        json.dumps({"seed": s, "deltaE": 23.0 + s, "mse": 0.03, **cfg}) + "\n" for s in range(3)))
    tpu_log = "batch 0: rel fitness gap 1.00e-02 1.00e-02  assign flips 0.00e+00  (engine 1.00s)\n" \
              "batch 1: rel fitness gap 1.00e-06 2.00e-06  assign flips 0.00e+00  (engine 1.00s)\n"
    (evidence / "tpu.log").write_text(tpu_log)
    assert engine_run.main(["--content", "natural", "--size", str(size), "--colors", str(k), "--imax",
                            str(imax), "--seeds", "0-1", "--out", str(out / "fp32_full.jsonl"),
                            "--cpu"]) == 0
    monkeypatch.setattr(chip_c2, "EVIDENCE", str(evidence))
    monkeypatch.setattr(chip_c2, "H100", str(h100))
    monkeypatch.setattr(chip_c2, "IMAX", imax)
    monkeypatch.setattr(chip_c2, "CONFIGS", {
        "config1nat": ("natural", size, k, "jax.jsonl", "oracle.jsonl", 2, "fp32_full.jsonl")})
    monkeypatch.setattr(chip_c2, "LAYER2", (("tiny", "natural", 48, 8),))
    monkeypatch.setattr(chip_c2, "FINGERPRINT", (("tiny", "natural", 48, 8, "tpu.log"),))
    monkeypatch.setattr(chip_c2, "LAYER2_ARGS", ["--palettes", "2", "--population", "2", "--cpu"])
    monkeypatch.setattr(chip_c2, "BANKS", (("config1nat", "fp32", "device", "0-1", "", ""),
                                           ("config1nat", "fp32", "device", "0", "", "_rerun"),
                                           ("config1nat", "f32x3", "jax", "0-2", "", "")))
    chip_c2.layer2(str(out), "cpu")
    (h100 / "fitness_parity_tiny.log").write_text((out / "fitness_parity_split_tiny.log").read_text())
    results = chip_c2.fingerprint(str(out), "cpu")
    verdict, stats = results["tiny"]
    assert verdict.startswith("DETERMINISTIC PARITY: PASS") and set(stats) == {"fp32", "split", "f32x3"}
    log = (out / "fitness_parity_f32x3_tiny.log").read_text()
    assert log.startswith("fitness: split_assign at f32x3, then B2 conv split")
    table = (out / "fingerprint_tiny.txt").read_text().splitlines()
    assert "; 2 palettes" in table[0] and table[-1].startswith("|TPU - port|: fp32 max")
    chip_c2.banks(str(out), float("inf"), "cpu")
    chip_c2.reports(str(out))
    assert chip_c2.reruns(str(out))
    recs = [json.loads(line) for line in open(out / "draws_config1nat_f32x3_jax.jsonl")]
    assert [(r["seed"], r["assign"], r["conv"], r["draws"]) for r in recs] == [
        (s, "split", "split", "jax") for s in range(3)]
    assert "paired over 3 seeds" in (out / "paired_config1nat_f32x3_jax.txt").read_text()
    assert "bit for bit on 1/1 seeds" in (out / "rerun_config1nat_fp32_device.txt").read_text()
    assert not (out / "report_config1nat_fp32_device_rerun_vs_jax.txt").exists()
    text = capsys.readouterr().out
    assert "[fingerprint] tiny: |TPU - port|:" in text
    # one flag names the fitness: fp32, split, f32x3 or xla, nothing else
    assert list(chip_draws.FITNESS) == ["fp32", "split", "f32x3", "xla"]
    with pytest.raises(SystemExit):
        chip_draws.parse_args(["--fitness", "bf16"])
