"""The port's quality-parity tools and public surface, against the JAX
package's on the CPU.

The tools (`hybridquantization_tpu_torch/tools/{parity_check,fitness_parity,
engine_run,entry}.py`) run here with device="cpu", where the kernels' plain
versions run, at small sizes. Both packages' tools are judged by the same
f64 oracle, `tests/oracle.py`.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as j_entry
from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import ops as j_ops
from hybridquantization_tpu import scielab as j_scielab
from hybridquantization_tpu import swasa as j_swasa
from hybridquantization_tpu.ops import assign as j_assign
from hybridquantization_tpu.ops import conv as j_conv
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu.scielab.filters import build_filters as j_build_filters
from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig, ops, scielab, swasa
from hybridquantization_tpu_torch import colorspace as cs
from hybridquantization_tpu_torch.ops import assign, conv
from hybridquantization_tpu_torch.pipeline import _make_context, make_fitness, make_population_fitness
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.swasa.loop import as_population_fitness
from hybridquantization_tpu_torch.tools import engine_run, entry, fitness_parity, parity_check

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parent.parent
# fitness values, port against JAX at f32x3: relative, as the mean dE of
# tests/test_torch_pipeline.py (MEAN_DE_RTOL); JAX's fused f32x3 conv is ~1e-5
# relative (fused_fitness.py:42-51), and random palettes on a 32x32 image give
# errors of 30-60, where the absolute 2e-5 of small fitness values is 2 ulp
FIT_RTOL = 1e-5
# JAX's jnp fitness (make_fitness, __graft_entry__) at f32x3 splits its conv
# operands into bf16 parts: 6.6e-5 relative off the fp32 one at 256x256/K64,
# where the port is 6.4e-8 off JAX's at "highest"
ENTRY_RTOL = 1e-4
# a 21-tap fp32 filter in another summation order (tests/test_conv.py's 1e-5 at 5 taps)
CONV_RTOL, CONV_ATOL = 1e-6, 1e-5
COLOR_ATOL = 1e-5  # Lloyd-step palettes (tests/test_torch_pipeline.py)
LAB_RTOL, LAB_ATOL = 1e-5, 1e-4  # S-CIELAB values (tests/test_torch_pipeline.py)
JAX_KEYS = {"seed", "deltaE", "mse", "precision", "size", "colors", "imax", "population",
            "content", "assignment_space", "anneal_seconds"}


def _jax_tool(name: str):
    """A module of the JAX package's `tools/` (not a package), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("content", ["smooth", "natural"])
@pytest.mark.parametrize("size", [32, 72])
def test_content_image_is_bit_equal_to_the_jax_tools(content, size):
    want = _jax_tool("parity_check").content_image(content, size)
    got = parity_check.content_image(content, size)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fitness_parity_passes_on_the_cpu(capsys):
    rc = fitness_parity.main(
        ["--size", "32", "--colors", "8", "--palettes", "2", "--population", "2"], device="cpu"
    )
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("batch 0: rel fitness gap") and "assign flips" in lines[2]
    assert lines[-1].startswith("DETERMINISTIC PARITY: PASS")


@pytest.mark.parametrize("content", ["smooth", "natural"])
def test_fitness_parity_engine_matches_jax(content):
    """The tool's engine side (B1 and B2's plain versions here) against JAX's
    population fitness on the tool's own palette batches, tie stress included.
    In the stress batch, member 1's entry 1 is entry 0 times 1 + 1e-7: two
    f32 score computations may split that near tie differently (here the
    port's split agrees with the f64 oracle's), which moves the member's
    error by whole unused-colour penalties (delta) and nothing else."""
    img = parity_check.content_image(content, 32)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=2))
    evaluate = fitness_parity.engine_fitness(img, cfg, torch.device("cpu"))
    jcfg = JConfig(swasa=JSWASA(num_colors=8, population=2))
    jfilters = j_build_filters()
    jfit = j_pop_fitness(j_make_context(jnp.asarray(img), jfilters, jcfg), jcfg, jfilters.half_width)
    rng = np.random.default_rng(fitness_parity.PALETTE_SEED)
    for b in range(2):
        pals = fitness_parity.palette_batch(rng, b, 2, 8)
        errs, idx = evaluate(pals)
        want, _ = jax.device_get(jfit(jnp.asarray(pals)))
        diff = errs.astype(np.float64) - want
        if b == 0:
            diff[1] -= cfg.swasa.delta * np.round(diff[1] / cfg.swasa.delta)
        assert np.all(np.abs(diff) <= FIT_RTOL * np.abs(want)), (errs, want)
        np.testing.assert_array_equal(idx, np.asarray(j_assign.nearest_palette(
            jnp.asarray(img.reshape(-1, 3)), jnp.asarray(pals[0]))))


def test_engine_run_records_resume_and_the_frozen_report_reads_them(tmp_path, capsys):
    out = tmp_path / "port.jsonl"
    argv = ["--size", "24", "--colors", "4", "--imax", "10", "--seeds", "0-1", "--out", str(out)]
    assert engine_run.main(argv, device="cpu") == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["seed"] for r in recs] == [0, 1]
    assert set(recs[0]) == JAX_KEYS | {"engine", "device", "compile_inclusive"}
    assert set(recs[1]) == JAX_KEYS | {"engine", "device"}
    assert all(r["engine"] == "torch" and r["device"] == "cpu" for r in recs)
    assert all(np.isfinite(r["deltaE"]) and r["deltaE"] > 0 for r in recs)
    before = out.read_text()
    capsys.readouterr()
    assert engine_run.main(argv, device="cpu") == 0
    assert "seeds todo [] (already done: [0, 1])" in capsys.readouterr().out
    assert out.read_text() == before
    jax_bank = tmp_path / "jax.jsonl"
    jax_bank.write_text("".join(
        json.dumps({"seed": s, "deltaE": 30.0 + s, "mse": 0.04, "precision": "f32x3", "size": 24,
                    "colors": 4, "imax": 10, "population": 4, "anneal_seconds": 1.0}) + "\n"
        for s in range(3)))
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "parity_report.py"), "--engine", str(out),
         "--oracle", str(jax_bank)], capture_output=True, text=True, timeout=60,
    )
    assert r.returncode in (0, 1), r.stderr
    assert "n=2" in r.stdout and any(ln.startswith("PARITY:") for ln in r.stdout.splitlines())


def test_parity_check_runs_to_its_end_with_a_spawned_oracle_worker(capsys):
    rc = parity_check.main(["--size", "24", "--colors", "4", "--imax", "10", "--seeds", "2",
                            "--oracle-jobs", "1"], device="cpu")
    out = capsys.readouterr().out
    assert rc in (0, 1)
    for s in (0, 1):
        assert f"[ours]   seed {s}: deltaE" in out and f"[oracle] seed {s}: deltaE" in out
    assert "mean deltaE: ours" in out and "PARITY: " in out


@pytest.mark.parametrize("tool", [fitness_parity, engine_run, parity_check, entry],
                         ids=["fitness_parity", "engine_run", "parity_check", "entry"])
def test_tools_refuse_cuda_without_a_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {engine_run: ["--out", str(tmp_path / "x.jsonl")], entry: []}.get(tool, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["--size", "24"] if tool is not entry else argv)


def test_entry_matches_the_jax_entry():
    fn, (palettes,) = entry.entry(device="cpu")
    jfn, (jpalettes,) = j_entry.entry()
    np.testing.assert_array_equal(palettes.numpy(), np.asarray(jpalettes))
    got = fn(palettes).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jfn)(jpalettes)), rtol=ENTRY_RTOL)


# -- the public surface against JAX's -----------------------------------------


@pytest.mark.parametrize("port, jax_mod", [(ops, j_ops), (scielab, j_scielab), (swasa, j_swasa)],
                         ids=["ops", "scielab", "swasa"])
def test_public_names_cover_jax(port, jax_mod):
    assert set(jax_mod.__all__) <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_assign_with_usage_matches_jax():
    palette = _rand((8, 3), 0)
    exact = palette[np.array([1, 5, 5, 7])]  # pixels exactly at 3 entries (tests/test_assign.py)
    pixels = np.concatenate([exact, _rand((200, 3), 1)])
    idx, used = ops.assign_with_usage(torch.as_tensor(pixels), torch.as_tensor(palette))
    j_idx, j_used = j_assign.assign_with_usage(jnp.asarray(pixels), jnp.asarray(palette))
    np.testing.assert_array_equal(idx.numpy()[:4], [1, 5, 5, 7])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(used.numpy(), np.asarray(j_used))


@pytest.mark.parametrize("shape, taps", [((2, 21, 19), 5), ((7, 30, 40), 21), ((1, 6, 6), 9)])
def test_separable_conv2d_symmetric_matches_jax(shape, taps):
    x, k = _rand(shape, 2), _rand((shape[0], taps), 3)
    got = ops.separable_conv2d_symmetric(torch.as_tensor(x), torch.as_tensor(k)).numpy()
    want = np.asarray(j_conv.separable_conv2d_symmetric(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)
    assert conv.separable_conv2d_symmetric is ops.separable_conv2d_symmetric


@pytest.mark.parametrize("K", [4, 16])
def test_lloyd_step_matches_jax(K):
    pixels, palette = _rand((3000, 3), 4), _rand((K, 3), 5)
    palette[1] = 2.0  # an entry no pixel selects keeps its colour
    got = assign.lloyd_step(torch.as_tensor(pixels), torch.as_tensor(palette)).numpy()
    want = np.asarray(j_assign.lloyd_step(jnp.asarray(pixels), jnp.asarray(palette)))
    np.testing.assert_allclose(got, want, rtol=0, atol=COLOR_ATOL)
    np.testing.assert_array_equal(got[1], palette[1])


@pytest.mark.parametrize("against", ["jax_population_fitness", "population_fitness"])
def test_as_population_fitness(against):
    """A per-palette fitness lifted member by member, against the population
    fitness (B1 and B2's plain versions) and JAX's, at the shapes of
    test_fitness_parity_engine_matches_jax (so JAX reuses its compilation)."""
    img = parity_check.content_image("smooth", 32)
    pals = fitness_parity.palette_batch(np.random.default_rng(1), 1, 2, 8)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=2))
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    errs, usage = as_population_fitness(make_fitness(ctx, cfg))(torch.as_tensor(pals))
    assert errs.shape == (2,) and usage.shape == (2, 8)
    if against == "population_fitness":
        want_e, want_u = (t.numpy() for t in make_population_fitness(ctx, cfg)(torch.as_tensor(pals)))
    else:
        jcfg = JConfig(swasa=JSWASA(num_colors=8, population=2))
        jfilters = j_build_filters()
        jfit = j_pop_fitness(j_make_context(jnp.asarray(img), jfilters, jcfg), jcfg, jfilters.half_width)
        want_e, want_u = jax.device_get(jfit(jnp.asarray(pals)))
    np.testing.assert_allclose(errs.numpy(), want_e, rtol=FIT_RTOL)
    np.testing.assert_array_equal(usage.numpy(), want_u)


def test_random_palette_is_one_uniform_draw():
    got = swasa.schedule.random_palette(torch.Generator().manual_seed(3), 16)
    want = torch.rand((16, 3), generator=torch.Generator().manual_seed(3))
    assert got.shape == (16, 3) and torch.equal(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    assert j_swasa.schedule.random_palette(jax.random.PRNGKey(0), 16).shape == got.shape


def test_scielab_exports_match_jax():
    assert scielab.samples_per_degree(72, 45.0) == j_scielab.samples_per_degree(72, 45.0)
    assert scielab.samples_per_degree(300, 30.0) == j_scielab.samples_per_degree(300, 30.0)
    opp = _rand((3, 28, 30), 8)
    f, jf = build_filters(), j_build_filters()
    got = scielab.scielab_filter_opp(torch.as_tensor(opp), f).numpy()
    want = np.asarray(j_scielab.scielab_filter_opp(jnp.asarray(opp), jf))
    np.testing.assert_allclose(got, want, rtol=LAB_RTOL, atol=LAB_ATOL)
    got = scielab.opp_to_scielab(torch.as_tensor(opp), f, cs.WHITEPOINT_D65).numpy()
    want = np.asarray(j_scielab.opp_to_scielab(jnp.asarray(opp), jf, np.asarray(cs.WHITEPOINT_D65)))
    np.testing.assert_allclose(got, want, rtol=LAB_RTOL, atol=LAB_ATOL)
