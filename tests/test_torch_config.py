"""The torch port's configuration, numpy copies and import rules, against
the JAX package."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hybridquantization_tpu import config as jcfg
from hybridquantization_tpu import io as jio
from hybridquantization_tpu import synth as jsynth
from hybridquantization_tpu.scielab import filters as jfilters
from hybridquantization_tpu_torch import config as tcfg
from hybridquantization_tpu_torch import convert, synth as tsynth
from hybridquantization_tpu_torch import io as tio
from hybridquantization_tpu_torch.pipeline import HybridQuantizer
from hybridquantization_tpu_torch.scielab import filters as tfilters

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["SWASAConfig", "ScielabConfig", "QuantizationConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    assert getattr(tcfg, name)().__dict__.keys() == getattr(jcfg, name)().__dict__.keys()
    for a, b in zip(jf, tf):
        want = a.default if a.default is not dataclasses.MISSING else a.default_factory()
        got = b.default if b.default is not dataclasses.MISSING else b.default_factory()
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), a.name
        else:
            assert got == want, a.name


@pytest.mark.parametrize(
    "kwargs",
    [
        {"precision": "bf16"},
        {"conv_precision": "bf16"},
        {"tie_mode": "average"},
        {"init": "kmeans", "precision": "bf16"},
    ],
)
def test_unported_values_raise_not_implemented(kwargs):
    """The fast modes, once refused naming ROADMAP A11, are ported: every
    value constructs. What is left unported needs more than one GPU and is
    refused by the CLI (A13, tests/test_torch_batch.py)."""
    cfg = tcfg.QuantizationConfig(**kwargs)
    assert all(getattr(cfg, k) == v for k, v in kwargs.items())


@pytest.mark.parametrize(
    "kwargs", [{"deltaE": "CIE2001"}, {"assignment_space": "xyz"}, {"precision": "f16"}]
)
def test_unknown_values_raise_value_error(kwargs):
    with pytest.raises(ValueError, match="unknown"):
        tcfg.QuantizationConfig(**kwargs)


@pytest.mark.parametrize("dpi,dist", [(72, 45.0), (300, 60.0), (96, 30.0), (600, 45.0)])
def test_build_filters_copy_is_bit_equal(dpi, dist):
    a = jfilters.build_filters(dpi, dist)
    b = tfilters.build_filters(dpi, dist)
    for f in ("k1", "k2", "k3", "k3_abs"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert getattr(b, f).dtype == np.float32
    assert b.samp_per_deg == a.samp_per_deg


@pytest.mark.parametrize("h,w,seed", [(48, 64, 0), (33, 70, 5)])
def test_synth_copies_are_bit_equal(h, w, seed):
    np.testing.assert_array_equal(
        tsynth.natural_image(h, w, seed=seed), jsynth.natural_image(h, w, seed=seed)
    )
    np.testing.assert_array_equal(
        tsynth.smooth_test_image(h, np.random.default_rng(seed)),
        jsynth.smooth_test_image(h, np.random.default_rng(seed)),
    )


def test_io_layout_converters_are_bit_equal():
    img = tsynth.natural_image(9, 13, seed=1)
    planar = jio.hwc_to_planar(img)
    np.testing.assert_array_equal(tio.hwc_to_planar(img), planar)
    np.testing.assert_array_equal(tio.planar_to_hwc(planar, 13), jio.planar_to_hwc(planar, 13))
    flat = jio.hwc_to_interleaved_rgba(img)
    np.testing.assert_array_equal(tio.hwc_to_interleaved_rgba(img), flat)
    np.testing.assert_array_equal(
        tio.interleaved_rgba_to_hwc(flat, 13), jio.interleaved_rgba_to_hwc(flat, 13)
    )


@pytest.mark.parametrize("ext", [".ppm", ".png"])
def test_io_file_copy_is_bit_equal(tmp_path, ext):
    img = tsynth.natural_image(11, 17, seed=2) * 1.1 - 0.05  # out of range: clipped on save
    tio.save_image(str(tmp_path / f"t{ext}"), img)
    jio.save_image(str(tmp_path / f"j{ext}"), img)
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    np.testing.assert_array_equal(
        tio.load_image(str(tmp_path / f"j{ext}")), jio.load_image(str(tmp_path / f"j{ext}"))
    )


def test_io_reads_pgm_and_16_bit_ppm_like_the_original(tmp_path):
    rng = np.random.default_rng(3)
    pgm = tmp_path / "g.pgm"
    pgm.write_bytes(b"P5\n# comment\n5 4\n255\n" + rng.integers(0, 256, 20, dtype=np.uint8).tobytes())
    ppm = tmp_path / "w.ppm"
    ppm.write_bytes(b"P6 3 2 65535\n" + rng.integers(0, 65536, 18).astype(">u2").tobytes())
    for p in (pgm, ppm):
        got = tio.load_image(str(p))
        np.testing.assert_array_equal(got, jio.load_image(str(p)))
        assert got.dtype == np.float32 and got.shape[-1] == 3


def test_filters_from_numpy_carries_the_bank_over():
    a = jfilters.build_filters(150, 50.0)
    b = convert.filters_from_numpy(a.k1, a.k2, a.k3, a.k3_abs, a.samp_per_deg)
    for f in ("k1", "k2", "k3", "k3_abs"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert (b.taps, b.half_width, b.samp_per_deg) == (a.taps, a.half_width, a.samp_per_deg)


def test_import_loads_no_jax():
    code = (
        "import sys, hybridquantization_tpu_torch as p\n"
        "import hybridquantization_tpu_torch.convert, hybridquantization_tpu_torch.synth\n"
        "import hybridquantization_tpu_torch.ops._cuda, hybridquantization_tpu_torch.ops.kmeans\n"
        "import hybridquantization_tpu_torch.cli, hybridquantization_tpu_torch.checkpoint\n"
        "import hybridquantization_tpu_torch.io, hybridquantization_tpu_torch.metrics\n"
        "import hybridquantization_tpu_torch.parallel.batch, hybridquantization_tpu_torch.native\n"
        "import hybridquantization_tpu_torch.batching, hybridquantization_tpu_torch.ops.probe_kernels\n"
        "import hybridquantization_tpu_torch.tools.vpu_assign_exp\n"
        "import hybridquantization_tpu_torch.tools.kexp_assign\n"
        "import hybridquantization_tpu_torch.tools.minidot_probe\n"
        "import hybridquantization_tpu_torch.tools.bench_multichip\n"
        "import hybridquantization_tpu_torch.tools.dryrun_multichip\n"
        "import hybridquantization_tpu_torch.tools.parity_check\n"
        "import hybridquantization_tpu_torch.tools.fitness_parity\n"
        "import hybridquantization_tpu_torch.tools.engine_run\n"
        "import hybridquantization_tpu_torch.tools.entry\n"
        "import hybridquantization_tpu_torch.tools.oracle_run\n"
        "import hybridquantization_tpu_torch.tools.tpu_f32x3\n"
        "import hybridquantization_tpu_torch.tools.jax_draws\n"
        "import hybridquantization_tpu_torch.tools.paired, hybridquantization_tpu_torch.tools.steps\n"
        "import hybridquantization_tpu_torch.parallel.mesh, hybridquantization_tpu_torch.parallel.multihost\n"
        "import hybridquantization_tpu_torch.parallel.population, hybridquantization_tpu_torch.parallel.halo\n"
        "import hybridquantization_tpu_torch.parallel.sharded, hybridquantization_tpu_torch.parallel.fast\n"
        "import tests._torch_mesh_worker\n"
        "import chip_smoke, chip_profile, chip_mesh, chip_parity, chip_draws, chip_c2, chip_steps, chip_band\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('hybridquantization_tpu.') or m == 'hybridquantization_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tf32_is_off_once_a_device_is_set_up():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    q = HybridQuantizer(tcfg.QuantizationConfig(), device="cpu")
    assert q.device == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_device_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridQuantizer(tcfg.QuantizationConfig())


@pytest.mark.parametrize(
    "script", ["chip_smoke.py", "chip_profile.py", "chip_parity.py", "chip_draws.py", "chip_c2.py", "chip_band.py"]
)
def test_chip_scripts_refuse_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout
