"""The rest of a run, without the look for a card, on the CPU at a small
size: sound, it comes out correct against the committed limits; with the
timed path broken underneath, or with the TF32 control in the program's
place, it does not."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import cells, harness
from benchmark.tests.conftest import tiny_root
from benchmark.tracing import Tracer
from hybridquantization_tpu_torch import pipeline
from hybridquantization_tpu_torch.parallel import BatchQuantizer

SINGLE, BATCH, PLUGIN = "single_4k.quality", "batch_mixed.quality64", "single_4k.plugin_defaults"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


def execute(root, name, seconds=3.0):
    cell = cells.load(name, root)
    return harness.execute(cell, 2**31 + 11, seconds, False, "cpu", time.perf_counter())


def altered_quantize(monkeypatch, cls):
    """A pixel of the quantized image altered where it is produced."""
    original = cls.quantize

    def quantize(self, images, palettes, *args, **kwargs):
        out = original(self, images, palettes, *args, **kwargs).clone()
        pal = palettes.reshape(-1, 3)
        flat = out.reshape(-1, 3)
        flat[7] = pal[-1] if not torch.equal(flat[7], pal[-1]) else pal[0]
        return out

    monkeypatch.setattr(cls, "quantize", quantize)


def half_the_pixels_in_the_fitness(monkeypatch):
    """B2's sums over the first half of the rows, the mean taken over them."""
    original = pipeline.fused_scielab_err_sums

    def sums(q, target, *args, **kwargs):
        h = q.shape[-2] // 2
        return 2 * original(q[..., :h, :].contiguous(), target[..., :h, :].contiguous(), *args, **kwargs)

    monkeypatch.setattr(pipeline, "fused_scielab_err_sums", sums)


def half_the_error_image(monkeypatch):
    """The mean Delta-E over the first half of the rows."""
    original = pipeline.HybridQuantizer.error_image

    def error_image(self, a, b):
        _, viz = original(self, a, b)
        e = 255.0 - torch.sqrt(viz[..., 0] * 255.0**2)
        return e[: e.shape[0] // 2].mean(), viz

    monkeypatch.setattr(pipeline.HybridQuantizer, "error_image", error_image)


@pytest.mark.parametrize("name", [SINGLE, BATCH, PLUGIN])
def test_a_sound_run_is_correct(root, name):
    result = execute(root, name, seconds=15.0)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m.name for m in cells.load(name, root).end_to_end}
    assert list(result)[-1] == "checks"


FAULTS = {
    "altered_quantize": lambda mp, name: altered_quantize(
        mp, BatchQuantizer if name == BATCH else pipeline.HybridQuantizer),
    "half_fitness": lambda mp, name: half_the_pixels_in_the_fitness(mp),
    "half_error_image": lambda mp, name: half_the_error_image(mp),
}


@pytest.mark.parametrize("name,fault", [
    (SINGLE, "altered_quantize"), (SINGLE, "half_fitness"), (SINGLE, "half_error_image"),
    (BATCH, "altered_quantize"), (BATCH, "half_fitness"), (BATCH, "half_error_image"),
    (PLUGIN, "altered_quantize"), (PLUGIN, "half_fitness"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch, name)
    result = execute(root, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", [SINGLE, BATCH])
def test_the_control_is_not_correct(root, name):
    cell = cells.load(name, root)
    run = harness.Run(cell, 7, "cpu", Tracer(False))
    records = run.job(0)[0] if run.batch else [r for i in range(2) for r in run.job(i)[0]]
    program, _ = harness.judge(run, records)
    control, _ = harness.judge(run, records, control=True)
    assert harness.checks.verdict(program, cell.limits)[0]
    assert not harness.checks.verdict(control, cell.limits)[0]
