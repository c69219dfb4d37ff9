"""The torch port's checkpoints (`checkpoint.py`) and the generator round trip
of `swasa/state.py`, with a checkpoint written by the JAX package."""

import os

import jax
import numpy as np
import pytest
import torch

from hybridquantization_tpu import QuantizationConfig as JConfig
from hybridquantization_tpu import SWASAConfig as JSWASA
from hybridquantization_tpu.checkpoint import save_state as j_save_state
from hybridquantization_tpu.pipeline import HybridQuantizer as JQuantizer
from hybridquantization_tpu.pipeline import _make_context as j_make_context
from hybridquantization_tpu.pipeline import make_population_fitness as j_pop_fitness
from hybridquantization_tpu.swasa import loop as jloop
from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
from hybridquantization_tpu_torch import checkpoint
from hybridquantization_tpu_torch.swasa.state import state_from_numpy, state_to_numpy
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

_TENSORS = ("colors", "current_errors", "best_colors", "best_error", "temperature", "iteration")


def _engine(imax=10, **kw):
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=5, population=3, imax=imax), **kw)
    return HybridQuantizer(cfg, device="cpu"), natural_image(24, 28, seed=4)


def _assert_same_state(a, b):
    for k in _TENSORS:
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0, atol=0)
    torch.testing.assert_close(
        torch.rand(4, generator=a.generator), torch.rand(4, generator=b.generator), rtol=0, atol=0
    )


def test_generator_state_from_another_device_type_is_refused():
    q, img = _engine(imax=2)
    d = state_to_numpy(q.find_palette(img)[1]["state"])
    assert str(d["generator_device"]) == "cpu"
    # The fault: a CUDA generator's state (a seed and an offset, 16 bytes)
    # does not fit a CPU generator, and set_state fails with a size error.
    cuda_like = dict(d, generator=np.zeros(16, np.uint8), generator_device=np.asarray("cuda"))
    with pytest.raises(RuntimeError, match="size"):
        torch.Generator().set_state(torch.tensor(cuda_like["generator"]))
    # state_from_numpy names both devices instead, in either direction
    with pytest.raises(ValueError, match="saved on a cuda device.*cpu"):
        state_from_numpy(cuda_like, "cpu")
    with pytest.raises(ValueError, match="saved on a cpu device.*cuda"):
        state_from_numpy(d, "cuda")
    assert state_from_numpy(d).generator.device.type == "cpu"


def test_save_load_round_trip(tmp_path):
    q, img = _engine(imax=4)
    state = q.find_palette(img)[1]["state"]
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, state, {"best_error": 1.5, "note": "x"})
    loaded, extra = checkpoint.load_state(path)
    _assert_same_state(loaded, state)
    assert float(extra["best_error"]) == 1.5 and str(extra["note"]) == "x"
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


def test_interrupted_run_resumed_from_a_checkpoint_equals_one_run(tmp_path):
    q, img = _engine(imax=12, init="kmeans")
    path = str(tmp_path / "ck.npz")
    _, full = q.find_palette(img, chunk_size=4)
    _, part = q.find_palette(
        img, chunk_size=4, checkpoint_path=path, checkpoint_every=4, progress=lambda d, n, t: d < 8
    )
    assert part["iterations"] == 8
    state, _ = checkpoint.load_state(path)
    assert int(state.iteration) == 8
    _, rest = q.find_palette(img, chunk_size=4, initial_state=state)
    assert rest["iterations"] == 12
    _assert_same_state(rest["state"], full["state"])
    assert rest["best_error"] == full["best_error"]


def test_checkpoint_cadence(monkeypatch):
    saved = []
    monkeypatch.setattr(
        "hybridquantization_tpu_torch.pipeline.save_state",
        lambda path, state: saved.append(int(state.iteration)),
    )
    q, img = _engine(imax=10)
    q.find_palette(img, chunk_size=3, checkpoint_path="unused.npz", checkpoint_every=5)
    assert saved == [6]  # chunks end at 3, 6, 9, 10; only 6 lies 5 or more past the last save


def test_newer_version_is_refused(tmp_path):
    q, img = _engine(imax=2)
    path = str(tmp_path / "ck.npz")
    d = state_to_numpy(q.find_palette(img)[1]["state"])
    np.savez(path, __version__=np.int32(2), **d)
    with pytest.raises(ValueError, match="version 2 is newer"):
        checkpoint.load_state(path)


def test_failed_write_removes_the_temp_file_and_keeps_the_old_one(tmp_path, monkeypatch):
    q, img = _engine(imax=2)
    state = q.find_palette(img)[1]["state"]
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, state)
    before = open(path, "rb").read()

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_state(path, state)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    assert open(path, "rb").read() == before


def test_jax_written_checkpoint_loads_and_resumes(tmp_path):
    jcfg = JConfig(swasa=JSWASA(num_colors=5, population=3, imax=6), use_pallas="off")
    jq = JQuantizer(jcfg)
    q, img = _engine(imax=6)
    jfit = j_pop_fitness(j_make_context(img, jq.filters, jcfg), jcfg, jq.filters.half_width)
    jstate = jloop.init_state(jax.random.PRNGKey(2), jfit, jcfg.swasa)
    path = str(tmp_path / "jax.npz")
    j_save_state(path, jstate, {"best_error": float(jstate.best_error)})
    state, extra = checkpoint.load_state(path)
    np.testing.assert_array_equal(state.colors.numpy(), np.asarray(jstate.colors))
    assert float(state.best_error) == float(jstate.best_error) == float(extra["best_error"])
    assert state.iteration.dtype == torch.int32 and int(state.iteration) == 0
    _, info = q.find_palette(img, initial_state=state)
    assert info["iterations"] == 6 and info["best_error"] <= float(jstate.best_error)
