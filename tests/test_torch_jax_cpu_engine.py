"""`tests/jax_cpu_engine.py`: the JAX engine's layer-3 run on the CPU, at a
tiny size, against the frozen `tools/engine_run.py` run on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import jax_cpu_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, K, IMAX = 32, 4, 3
FLAGS = ["--content", "natural", "--size", str(SIZE), "--colors", str(K), "--imax", str(IMAX)]
#: the frozen tool's record keys (tools/engine_run.py)
KEYS = {"seed", "deltaE", "mse", "precision", "size", "colors", "imax", "population", "content",
        "assignment_space", "anneal_seconds"}


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_xla_branch_is_the_frozen_engine_run_off_the_tpu(tmp_path):
    out, series = tmp_path / "xla.jsonl", tmp_path / "series.jsonl"
    assert jax_cpu_engine.main([*FLAGS, "--seeds", "0", "--branch", "xla", "--out", str(out),
                                "--series", str(series)]) == 0
    ref = tmp_path / "frozen.jsonl"
    run = ("import jax; jax.config.update('jax_platforms', 'cpu'); import runpy, sys; "
           f"sys.argv = ['engine_run.py', *{[*FLAGS, '--seeds', '0', '--out', str(ref)]!r}]; "
           "runpy.run_path('tools/engine_run.py', run_name='__main__')")
    env = {**os.environ, "HQ_TPU_CACHE_DIR": str(tmp_path / "cache"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", run], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    (got,), (want,) = _records(out), _records(ref)
    assert (got["deltaE"], got["mse"]) == (want["deltaE"], want["mse"])
    assert KEYS <= set(got) and (got["engine"], got["branch"]) == ("jax-cpu", "xla")
    (line,) = _records(series)
    best = line["best_error"]
    assert len(best) == IMAX and best == sorted(best, reverse=True) and line["deltaE"] == got["deltaE"]


def test_f32x3_branch_runs_and_resumes(tmp_path, capsys):
    out, series = tmp_path / "f32x3.jsonl", tmp_path / "series.jsonl"
    argv = [*FLAGS, "--branch", "f32x3", "--out", str(out), "--series", str(series)]
    assert jax_cpu_engine.main([*argv, "--seeds", "0"]) == 0
    assert jax_cpu_engine.main([*argv, "--seeds", "0-1"]) == 0
    assert "seeds todo [1] (already done: [0])" in capsys.readouterr().out
    recs = _records(out)
    assert [r["seed"] for r in recs] == [0, 1] and [r["seed"] for r in _records(series)] == [0, 1]
    assert {(r["branch"], r["precision"]) for r in recs} == {("f32x3", "f32x3")}
    assert all(np.isfinite(r["deltaE"]) for r in recs)
    assert jax_cpu_engine.main([*argv, "--seeds", "0-1"]) == 0
    assert len(_records(out)) == 2


def test_steps_side_by_side_take_the_same_decisions_at_a_tiny_size(capsys):
    """`tests/jax_cpu_steps.py` steps JAX's anneal and the port's on the same
    draws; at 32^2, K=4 their first iterations decide alike."""
    from tests import jax_cpu_steps

    assert jax_cpu_steps.main(["--size", str(SIZE), "--colors", str(K), "--imax", "20", "--until", "5"]) == 0
    out = capsys.readouterr().out
    assert "start palettes equal" in out and "no decision differs through iteration 5" in out


def _xla_branch(size):
    """(image, JAX's jitted XLA-branch population fitness, its f32x3 index,
    the port's CPU context and config) at `size`^2 natural, K=16."""
    import jax
    import jax.numpy as jnp

    from hybridquantization_tpu import HybridQuantizer as JQuantizer
    from hybridquantization_tpu import QuantizationConfig as JConfig
    from hybridquantization_tpu import SWASAConfig as JSWASA
    from hybridquantization_tpu.ops import assign as jassign
    from hybridquantization_tpu.pipeline import _make_context as j_make_context
    from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.pipeline import _make_context
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.tools.parity_check import content_image

    img = content_image("natural", size)
    jcfg = JConfig(swasa=JSWASA(num_colors=16, population=4))
    jq = JQuantizer(jcfg)
    jfit = jax.jit(j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg,
                                 jq.filters.half_width))
    jidx = jax.jit(lambda x, p: jassign.nearest_palette(x, p, precision=jcfg.precision))
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=16, population=4))
    return img, jfit, jidx, _make_context(img, build_filters(), cfg, "cpu"), cfg


def test_xla_index_is_the_jax_xla_branch_assignment():
    """`tpu_f32x3.xla_f32x3_index` is JAX's XLA-branch assignment at f32x3
    pixel for pixel at 512^2 natural, 8 palettes; the engine's fp32 scores
    part from it on some pixels, so the check can tell the two apart."""
    import torch

    from hybridquantization_tpu_torch.ops.assign import nearest_palette
    from hybridquantization_tpu_torch.tools.tpu_f32x3 import xla_f32x3_index

    img, _, jidx, ctx, _ = _xla_branch(512)
    pixels = img.reshape(-1, 3)
    rng = np.random.default_rng(11)
    fp32_flips = 0
    for pal in rng.random((8, 16, 3), dtype=np.float32):
        want = np.asarray(jidx(pixels, pal))
        got = xla_f32x3_index(ctx["assign_pixels"], torch.from_numpy(pal)).numpy()
        np.testing.assert_array_equal(got, want)
        fp32_flips += int((nearest_palette(ctx["assign_pixels"], torch.from_numpy(pal)).numpy() != want).sum())
    assert fp32_flips > 0


#: the XLA-branch fitness against JAX's, relative: B2's fp32 sums against
#: XLA's banded-matmul conv and f32 mean (1.1e-7 median, 4.4e-7 most over
#: 32 palettes at 512^2 natural, K=16)
XLA_RTOL = 1e-6


def test_xla_fitness_is_the_jax_xla_branch_fitness():
    """`tpu_f32x3.make_xla_population_fitness` meets JAX's XLA-branch
    fitness within XLA_RTOL at 512^2 natural, 8 palettes; the engine's fp32
    fitness misses it by more than 3 limits on at least one of them."""
    import torch

    from hybridquantization_tpu_torch.pipeline import make_population_fitness
    from hybridquantization_tpu_torch.tools.tpu_f32x3 import make_xla_population_fitness

    _, jfit, _, ctx, cfg = _xla_branch(512)
    xla, fp32 = make_xla_population_fitness(ctx, cfg), make_population_fitness(ctx, cfg)
    rng = np.random.default_rng(11)
    far = 0.0
    for pals in rng.random((2, 4, 16, 3), dtype=np.float32):
        want = np.asarray(jfit(pals)[0], np.float64)
        got = xla(torch.from_numpy(pals))[0].numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=XLA_RTOL, atol=0)
        far = max(far, float(np.max(np.abs(fp32(torch.from_numpy(pals))[0].numpy() - want) / want)))
    assert far > 3 * XLA_RTOL


#: JAX's branch at precision "highest" against the port's fp32 fitness, relative: both f32, summed in
#: different orders (2.1e-7 median, 1.7e-6 most over 32 palettes at 512^2 natural, K=16)
HIGHEST_RTOL = 1e-6


def test_highest_is_the_port_fp32_function():
    """JAX's default branch at precision "highest" (`tests/jax_cpu_engine.py
    --branch xla --precision highest`) and the port's fp32 fitness agree
    within HIGHEST_RTOL at 64^2 natural, K=8, 4 palettes; their indices
    differ only inside the near-tie class."""
    import jax
    import jax.numpy as jnp
    import torch

    from hybridquantization_tpu import HybridQuantizer as JQuantizer
    from hybridquantization_tpu import QuantizationConfig as JConfig
    from hybridquantization_tpu import SWASAConfig as JSWASA
    from hybridquantization_tpu.ops import assign as jassign
    from hybridquantization_tpu.pipeline import _make_context as j_make_context
    from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
    from hybridquantization_tpu_torch import QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.ops.assign import nearest_palette
    from hybridquantization_tpu_torch.pipeline import _make_context, make_population_fitness
    from hybridquantization_tpu_torch.scielab.filters import build_filters
    from hybridquantization_tpu_torch.tools.parity_check import content_image
    from tests.jax_cpu_xla_scores import beyond_ties

    img = content_image("natural", 64)
    jcfg = JConfig(swasa=JSWASA(num_colors=8, population=4), precision="highest")
    jq = JQuantizer(jcfg)
    jfit = j_pop_fitness(j_make_context(jnp.asarray(img), jq.filters, jcfg), jcfg, jq.filters.half_width)
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=8, population=4))
    ctx = _make_context(img, build_filters(), cfg, "cpu")
    pals = np.random.default_rng(11).random((4, 8, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jfit)(pals)[0], np.float64)
    got = make_population_fitness(ctx, cfg)(torch.from_numpy(pals))[0].numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=HIGHEST_RTOL, atol=0)
    pixels = img.reshape(-1, 3)
    jidx = jax.jit(lambda x, p: jassign.nearest_palette(x, p, precision="highest"))
    for pal in pals:
        j = np.asarray(jidx(pixels, pal))
        p = nearest_palette(ctx["assign_pixels"], torch.from_numpy(pal)).numpy()
        assert beyond_ties(pixels.astype(np.float64), pal.astype(np.float64), j, p) == 0


def test_highest_precision_is_banked(tmp_path):
    out, series = tmp_path / "highest.jsonl", tmp_path / "series.jsonl"
    assert jax_cpu_engine.main([*FLAGS, "--seeds", "0", "--branch", "xla", "--precision", "highest",
                                "--out", str(out), "--series", str(series)]) == 0
    (rec,), (line,) = _records(out), _records(series)
    assert (rec["engine"], rec["branch"], rec["precision"]) == ("jax-cpu", "xla", "highest")
    assert KEYS <= set(rec) and np.isfinite(rec["deltaE"])
    assert (line["precision"], line["deltaE"], len(line["best_error"])) == ("highest", rec["deltaE"], IMAX)


def _start_jobs(monkeypatch, script, argv, seeds, jobs, pin):
    """`engine_run.run_jobs` with Popen and the cores faked (8 of them):
    each started (command, cores it was pinned to or None)."""
    from hybridquantization_tpu_torch.tools import engine_run

    started = []

    class Proc:
        def __init__(self, cmd, preexec_fn):
            calls = []
            monkeypatch.setattr(engine_run.os, "sched_setaffinity", lambda pid, cores: calls.append(cores))
            if preexec_fn is not None:
                preexec_fn()
            started.append((cmd, calls[0] if calls else None))

        def wait(self):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(engine_run.os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.setattr(engine_run.subprocess, "Popen", Proc)
    assert engine_run.run_jobs(script, argv, seeds, jobs, pin=pin) == 0
    assert all(cmd[1:2] == [script] and cmd[2:-4] == argv for cmd, _ in started)
    return started


def test_jobs_deal_the_seeds_round_robin_over_core_shares(monkeypatch):
    """`--jobs 4` on 8 cores: four processes of the script, two cores each,
    seeds dealt round-robin so the lowest finish first."""
    argv = [*FLAGS, "--branch", "xla", "--out", "bank.jsonl"]
    started = _start_jobs(monkeypatch, jax_cpu_engine.__file__, argv, [0, 1, 2, 3, 4, 5], 4, pin=True)
    assert [cores for _, cores in started] == [{0, 1}, {2, 3}, {4, 5}, {6, 7}]
    assert [cmd[-4:] for cmd, _ in started] == [["--seeds", s, "--jobs", "1"] for s in ("0,4", "1,5", "2", "3")]


def test_unpinned_jobs_deal_the_seeds_without_core_shares(monkeypatch):
    """`chip_steps.py --jobs 5`: five processes pinned nowhere (one
    intra-op thread each), one seed each, however few the cores."""
    started = _start_jobs(monkeypatch, "chip_steps.py", ["--to-end"], [25, 30, 35, 2, 13, 48], 5, pin=False)
    assert [cores for _, cores in started] == [None] * 5
    assert [cmd[-3] for cmd, _ in started] == ["25,48", "30", "35", "2", "13"]


C2 = os.path.join(REPO, "docs", "evidence_h100", "c2")
#: fault C3's fresh read set: JAX's f32 engine off the TPU on seeds 48-95, fixed before any of them ran
FRESH = os.path.join(C2, "jaxcpu_config1nat_highest_48-95.jsonl")
FRESH_SERIES = os.path.join(C2, "jaxcpu_config1nat_highest_48-95_series.jsonl")


def test_the_fresh_off_tpu_bank_is_jax_highest_on_seeds_48_to_95():
    recs = _records(FRESH)
    seeds = [r["seed"] for r in recs]
    assert sorted(seeds) == list(range(48, 96)) and len(set(seeds)) == len(seeds)
    assert {(r["engine"], r["branch"], r["precision"]) for r in recs} == {("jax-cpu", "xla", "highest")}
    assert {(r["content"], r["size"], r["colors"], r["imax"], r["population"]) for r in recs} == {
        ("natural", 512, 16, 1500, 4)}
    assert all(KEYS <= set(r) for r in recs)
    first = {r["seed"] for r in _records(os.path.join(C2, "jaxcpu_config1nat_highest.jsonl"))}
    assert first == set(range(48)) and not first & set(seeds)
    series = {r["seed"]: r for r in _records(FRESH_SERIES)}
    assert sorted(series) == list(range(48, 96))
    assert all(series[r["seed"]]["deltaE"] == r["deltaE"] and len(series[r["seed"]]["best_error"]) == 1500
               for r in recs)


def test_the_fresh_bank_reproduces_its_committed_verdict(tmp_path):
    """`tools/paired.py --verdict` on P (the port's fp32 engine on JAX's
    streams) and the fresh bank writes the committed verdict file."""
    from hybridquantization_tpu_torch.tools import paired

    out = tmp_path / "verdict.txt"
    assert paired.main([os.path.join(C2, "draws_config1nat_fp32_jax.jsonl"), FRESH,
                        "--labels", "port fp32,JAX highest off the TPU", "--verdict",
                        "--series", os.path.join(C2, "series_config1nat_fp32_jax_24-95.jsonl"), FRESH_SERIES,
                        "--series-rel", "1e-4", "--out", str(out)]) == 0
    want = open(os.path.join(C2, "paired_config1nat_fp32_jax_vs_jaxcpu_highest_48-95.txt")).read()
    assert out.read_text() == want
    assert want.startswith("paired over 48 seeds: port fp32 ")


def test_the_pooled_0_95_reading_reproduces_its_committed_file(tmp_path):
    """The reading beside the verdict: P against both J banks, their seeds
    pooled (REF named twice), over seeds 0-95."""
    from hybridquantization_tpu_torch.tools import paired

    out = tmp_path / "pooled.txt"
    assert paired.main([os.path.join(C2, "draws_config1nat_fp32_jax.jsonl"),
                        os.path.join(C2, "jaxcpu_config1nat_highest.jsonl"), FRESH,
                        "--labels", "port fp32,JAX highest off the TPU", "--verdict", "--out", str(out)]) == 0
    want = open(os.path.join(C2, "paired_config1nat_fp32_jax_vs_jaxcpu_highest_0-95.txt")).read()
    assert out.read_text() == want and want.startswith("paired over 96 seeds: ")


def test_a_missing_bank_file_is_an_error(tmp_path):
    from hybridquantization_tpu_torch.tools import paired

    with pytest.raises(SystemExit):
        paired.main([os.path.join(C2, "draws_config1nat_fp32_jax.jsonl"), FRESH, str(tmp_path / "typo.jsonl")])
