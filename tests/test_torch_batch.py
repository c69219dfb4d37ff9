"""The port's batch engine (`parallel.BatchQuantizer`, `quantize-batch`) on the
CPU: a bucket of images anneals in lockstep and each image's result equals
its single-image run; the batched fitness against the JAX package's; the
numpy copies `batching.py` and `native.py` against the originals."""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu import batching as jbatching
from hybridquantization_tpu import native as jnative
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import batching as tbatching
from hybridquantization_tpu_torch import io as tio
from hybridquantization_tpu_torch import native as tnative
from hybridquantization_tpu_torch.cli import main
from hybridquantization_tpu_torch.parallel import BatchQuantizer
from hybridquantization_tpu_torch.pipeline import (
    _make_batch_context,
    _make_context,
    make_population_fitness,
)
from hybridquantization_tpu_torch.scielab.filters import build_filters
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

ERR_ATOL = 2e-5  # population fitness against JAX's Pallas branch, as tests/test_torch_fused_fitness.py


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _images(n=3, h=36, w=44, seed=0):
    return np.stack([natural_image(h, w, seed=seed + i) for i in range(n)])


@pytest.mark.parametrize(
    "space,K,pop,kw",
    [
        ("srgb", 5, 3, {}),
        ("lab", 7, 3, {}),
        ("lab", 5, 4, {"precision": "bf16", "tie_mode": "average"}),
        ("srgb", 6, 2, {"conv_precision": "bf16"}),
    ],
)
def test_batched_fitness_is_bit_equal_to_single_images(space, K, pop, kw):
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=pop), assignment_space=space, **kw)
    imgs = _images()
    pals = _t(np.random.default_rng(1).random((3, pop, K, 3), dtype=np.float32))
    f = build_filters()
    err, use = make_population_fitness(_make_batch_context(imgs, f, cfg, "cpu"), cfg)(pals)
    assert err.shape == (3, pop) and use.shape == (3, pop, K)
    for i in range(3):
        e, u = make_population_fitness(_make_context(imgs[i], f, cfg, "cpu"), cfg)(pals[i])
        assert torch.equal(err[i], e) and torch.equal(use[i], u)


def test_batched_fitness_matches_jax_per_image():
    H, W, K, pop = 60, 72, 6, 3
    imgs = _images(3, H, W, seed=4)
    pals = np.random.default_rng(5).random((3, pop, K, 3), dtype=np.float32)
    pals[1, 0, 4] = pals[1, 0, 1]
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=pop))
    err, use = make_population_fitness(_make_batch_context(imgs, build_filters(), cfg, "cpu"), cfg)(_t(pals))
    jcfg = JConfig(swasa=JSWASA(num_colors=K, population=pop), use_pallas="on", precision="highest")
    jq = JQuantizer(jcfg)
    for i in range(3):
        jctx = j_make_context(jnp.asarray(imgs[i]), jq.filters, jcfg)
        j_err, j_use = jax.jit(j_pop_fitness(jctx, jcfg, jq.filters.half_width))(jnp.asarray(pals[i]))
        np.testing.assert_array_equal(use[i].numpy(), np.asarray(j_use))
        np.testing.assert_allclose(err[i].numpy(), np.asarray(j_err), rtol=0, atol=ERR_ATOL)


@pytest.mark.parametrize(
    "init,kw", [("random", {}), ("kmeans", {}), ("kmeans", {"precision": "bf16", "tie_mode": "average"})]
)
def test_each_image_equals_its_single_image_run(init, kw):
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=5, population=3, imax=7), init=init, seed=11, **kw
    )
    imgs = _images(seed=2)
    out, info = BatchQuantizer(cfg, device="cpu").run(imgs, polish_iters=2)
    assert out.shape == imgs.shape and info["palettes_polished"]
    assert info["telemetry"]["best_error"].shape == (7, 3)
    for i in range(3):
        q = HybridQuantizer(dataclasses.replace(cfg, seed=11 + i), device="cpu")
        pal, single = q.find_palette(imgs[i])
        assert torch.equal(info["state"].best_colors[i], pal)
        assert float(info["best_errors"][i]) == single["best_error"]
        np.testing.assert_array_equal(info["telemetry"]["best_error"][:, i], single["telemetry"]["best_error"])
        polished = q.polish(imgs[i], pal, 2)
        assert torch.equal(info["palettes"][i], polished)
        assert torch.equal(out[i], q.quantize(imgs[i], polished))


def test_permuting_the_batch_permutes_the_results():
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=3, imax=6), init="kmeans")
    imgs = _images(seed=6)
    seeds = np.array([7, 3, 9])
    perm = [2, 0, 1]
    bq = BatchQuantizer(cfg, device="cpu")
    pals, info = bq.find_palettes(imgs, seeds=seeds)
    ppals, pinfo = bq.find_palettes(imgs[perm], seeds=seeds[perm])
    assert torch.equal(ppals, pals[perm])
    np.testing.assert_array_equal(pinfo["best_errors"], info["best_errors"][perm])


def test_batch_progress_and_error_images():
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=4, population=2, imax=20))
    imgs = _images(2, seed=8)
    bq = BatchQuantizer(cfg, device="cpu")
    calls = []
    _, info = bq.find_palettes(imgs, progress=lambda d, n, s: calls.append((d, s)) or d < 10, chunk_size=5)
    assert [c[0] for c in calls] == [5, 10] and info["iterations"] == 10
    assert set(calls[0][1]) == {"best_error_mean", "eta_s"}
    out = bq.quantize(imgs, info["state"].best_colors)
    mean, viz = bq.error_images(imgs, out)
    assert mean.shape == (2,) and viz.shape == (2, 36, 44, 3)
    for i in range(2):
        m, v = bq.engine.error_image(imgs[i], out[i])
        assert float(mean[i]) == float(m) and torch.equal(viz[i], v)
    with pytest.raises(ValueError, match="B, H, W, 3"):
        bq.find_palettes(imgs[0])


def test_batching_copy_matches_the_original():
    sizes = [(4, 5), (2, 3), (4, 5), (6, 1), (2, 3), (4, 5)]
    for a, b in zip(tbatching.bucket_by_resolution(sizes), jbatching.bucket_by_resolution(sizes)):
        assert (a.resolution, a.indices) == (b.resolution, b.indices)
    for idx, m in [([1, 2, 3], 2), ([4], 3), ([5, 6], 1), ([1, 2, 3, 4], 4)]:
        assert tbatching.pad_indices(idx, m) == jbatching.pad_indices(idx, m)
    images = [np.full(s + (3,), i, np.float32) for i, s in enumerate(sizes)]

    def run(stack):
        return stack * 2, stack.sum(axis=(1, 2, 3))

    for n_data in (1, 2):
        got = tbatching.run_bucketed(images, run, n_data=n_data)
        want = jbatching.run_bucketed(images, run, n_data=n_data)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_native_copy_matches_the_original(tmp_path):
    img = natural_image(13, 17, seed=3)
    paths = []
    for ext in (".ppm", ".png"):
        p = str(tmp_path / f"im{ext}")
        tio.save_image(p, img)
        paths.append(p)
        np.testing.assert_array_equal(tnative.load_image(p), jnative.load_image(p))
    assert tnative.available() == jnative.available()
    np.testing.assert_array_equal(tnative.load_batch(paths), jnative.load_batch(paths))
    np.testing.assert_array_equal(tnative.hwc_to_planar(img), jnative.hwc_to_planar(img))
    planar = jnative.hwc_to_planar(img)
    np.testing.assert_array_equal(tnative.planar_to_hwc(planar, 17), jnative.planar_to_hwc(planar, 17))
    np.testing.assert_array_equal(tnative.float_to_u8(img * 1.2 - 0.1), jnative.float_to_u8(img * 1.2 - 0.1))


def test_quantize_batch_runs_through_the_cli(tmp_path, capsys):
    paths = []
    for i, (h, w) in enumerate([(36, 44), (30, 40), (36, 44)]):
        p = tmp_path / f"im{i}.ppm"
        tio.save_image(str(p), natural_image(h, w, seed=20 + i))
        paths.append(str(p))
    out_dir, err_dir = tmp_path / "out", tmp_path / "err"
    argv = [
        "quantize-batch", *paths, "--out-dir", str(out_dir), "-k", "5", "--imax", "6",
        "--population", "3", "--fast", "--init", "kmeans", "--polish", "2",
        "--error-images", str(err_dir), "--seed", "4",
    ]
    assert main(argv, device="cpu") == 0
    text = capsys.readouterr().out
    assert "mesh 1x1, 3 images, K=5" in text
    lines = [ln for ln in text.splitlines() if "error=" in ln]
    assert len(lines) == 3 and all("DeltaE=" in ln for ln in lines)
    assert re.search(r"batch done: \S+s, \S+ Mpix, \d+ Mpix-evals/s", text)
    for i, p in enumerate(paths):
        out = tio.load_image(str(out_dir / f"im{i}_q5.png"))
        assert out.shape == tio.load_image(p).shape
        assert len(np.unique(out.reshape(-1, 3), axis=0)) <= 5
        assert tio.load_image(str(err_dir / f"im{i}_DE.png")).shape == out.shape
    # the two 36x44 images ran as one bucket with seeds 4 and 5 (every bucket
    # counts its seeds from --seed, as in JAX); the 30x40 one alone
    cfg = QuantizationConfig(
        swasa=SWASAConfig(num_colors=5, population=3, imax=6), precision="bf16",
        tie_mode="average", init="kmeans",
    )
    imgs = np.stack([tio.load_image(paths[0]), tio.load_image(paths[2])])
    out, _ = BatchQuantizer(cfg, device="cpu").run(imgs, seeds=[4, 5], polish_iters=2)
    np.testing.assert_array_equal(tio.load_image(str(out_dir / "im2_q5.png")), _u8(out[1].numpy()))


def _u8(img):
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(np.float32) / 255.0


MESH_ARGS = ["-k", "5", "--imax", "6", "--population", "4", "--fast", "--init", "kmeans", "--polish", "2",
             "--seed", "4"]


@pytest.fixture(scope="module")
def mesh_inputs(tmp_path_factory):
    """Three inputs (two sizes) and the one-device command's outputs and
    printed lines, with its directories named <dir>."""
    d = tmp_path_factory.mktemp("mesh_cli")
    paths = []
    for i, (h, w) in enumerate([(36, 44), (30, 40), (36, 44)]):
        paths.append(str(d / f"im{i}.ppm"))
        tio.save_image(paths[-1], natural_image(h, w, seed=30 + i))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert main(_mesh_argv(paths, d / "one"), device="cpu") == 0
    return d, paths, _result_lines(text.getvalue(), d / "one")


def _mesh_argv(paths, out):
    return ["quantize-batch", *paths, *MESH_ARGS, "--out-dir", str(out), "--error-images", f"{out}_e"]


def _result_lines(text, out):
    return [ln.replace(f"{out}_e", "<dir>_e").replace(str(out), "<dir>") for ln in text.splitlines() if "error=" in ln]


@pytest.mark.parametrize(
    "flags,mesh",
    [(["--mesh-data", "2"], "mesh 2x1"), (["--mesh-pixel", "2"], "mesh 1x2"),
     (["--mesh-pop", "2"], "mesh 1x1"), (["--distributed"], "mesh 1x2")],
)
def test_quantize_batch_mesh_flags_match_one_device(flags, mesh, mesh_inputs, capfd):
    """Each mesh flag over 2 gloo ranks on the CPU: the files and the lines
    rank 0 writes equal the one-device command's. --mesh-* ranks are
    started by the command; --distributed joins two processes started
    here, each running the command with its --process-id."""
    import torch.multiprocessing as mp

    from . import _torch_mesh_worker as w

    d, paths, want = mesh_inputs
    out = d / "_".join(f.strip("-") for f in flags)
    argv = _mesh_argv(paths, out)
    if flags == ["--distributed"]:
        argv += ["--distributed", "--coordinator", f"file://{d}/rendezvous", "--num-processes", "2"]
        mp.start_processes(w.cli_rank, args=(argv,), nprocs=2, join=True, start_method="spawn")
    else:
        assert main(argv + flags, device="cpu") == 0
    text = capfd.readouterr().out
    assert f"{mesh}, 3 images, K=5 (" in text and "gloo on cpu" in text
    assert _result_lines(text, out) == want
    for i in range(3):
        for sub in (f"im{i}_q5.png", f"../{out.name}_e/im{i}_DE.png"):
            np.testing.assert_array_equal(tio.load_image(str(out / sub)), tio.load_image(str(d / "one" / sub)))
