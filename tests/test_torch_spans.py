"""The port's spans (`metrics.span`): nothing while no profiler records,
and `hq.<name>` ranges at every layer boundary, nested on the host thread,
while one does. On the CPU, through the engines' plain versions."""

import json

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig, io, metrics
from hybridquantization_tpu_torch.batching import run_bucketed
from hybridquantization_tpu_torch.cli import main
from hybridquantization_tpu_torch.parallel import BatchQuantizer
from hybridquantization_tpu_torch.pipeline import as_image
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

CFG = QuantizationConfig(swasa=SWASAConfig(num_colors=6, imax=12, population=3), init="kmeans")


def program_spans(path) -> list[tuple[str, float, float]]:
    """(name, ts, te) of the program's `hq.` ranges in a Chrome trace, by start."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("ph") == "X" and e["name"].startswith("hq.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def profiled(tmp_path, fn):
    """The program spans of fn() under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return program_spans(path)


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(spans, parent, name):
    """The spans called `name` that lie within `parent`."""
    return [s for s in named(spans, name) if parent[1] <= s[1] and s[2] <= parent[2]]


def test_span_off_calls_nothing_in_the_profiler(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    # one shared no-op, whatever the name: nothing allocated per span
    assert metrics.span("a") is metrics.span("b")
    with metrics.span("find_palette"):
        pass
    # the whole engine and the bucket loop run with every span off
    img = natural_image(24, 28, seed=1)
    q = HybridQuantizer(CFG, device="cpu")
    pal, _ = q.find_palette(img, progress=lambda *a: True)
    q.error_image(img, q.quantize(img, q.polish(img, pal, iters=2)))
    run_bucketed([img, img[:20]], lambda stack: (stack * 2,))


def test_span_off_runs_no_torch_op():
    class Ops(torch.overrides.TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Ops.calls += 1
            return func(*args, **(kwargs or {}))

    with Ops():
        with metrics.span("anneal.step"):
            pass
        assert Ops.calls == 0
        torch.ones(2).sum()
    assert Ops.calls > 0  # the mode sees the ops that do run


def test_span_on_is_a_host_range_named_hq_nested_on_the_thread(tmp_path):
    def fn():
        with metrics.span("outer"):
            with metrics.span("inner"):
                torch.ones(4).sum()

    spans = profiled(tmp_path, fn)
    (outer,) = named(spans, "hq.outer")
    assert len(inside(spans, outer, "hq.inner")) == 1
    # a "cpu_op" event, which the benchmark's trace reader keeps among the host's ranges
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {e["cat"] for e in events if e.get("name", "").startswith("hq.")} == {"cpu_op"}


def test_cli_profile_trace_holds_the_engine_spans(tmp_path):
    src = tmp_path / "in.ppm"
    io.save_image(str(src), natural_image(40, 48, seed=2))
    argv = ["quantize", str(src), str(tmp_path / "out.ppm"), "-k", "6", "--imax", "25", "--population", "3",
            "--init", "kmeans", "--polish", "2", "--error-image", str(tmp_path / "err.ppm"),
            "--profile", str(tmp_path / "prof")]
    assert main(argv, device="cpu") == 0
    spans = program_spans(tmp_path / "prof" / metrics.TRACE_FILE)
    (fp,) = named(spans, "hq.find_palette")
    for child in ("hq.context", "hq.seeding", "hq.init"):
        assert len(inside(spans, fp, child)) == 1, child
    chunks = inside(spans, fp, "hq.anneal.chunk")
    assert len(chunks) == 3  # 25 iterations in chunks of 10
    steps = [len(inside(spans, c, "hq.anneal.step")) for c in chunks]
    assert steps == [10, 10, 5]  # one step a iteration
    assert all(len(inside(spans, c, "hq.anneal.readback")) == 1 for c in chunks)
    # each step launches B1 and B2 once; the seeding's Lloyd steps run B3
    for step in inside(spans, fp, "hq.anneal.step"):
        assert len(inside(spans, step, "hq.b1")) == len(inside(spans, step, "hq.b2")) == 1
    assert inside(spans, inside(spans, fp, "hq.seeding")[0], "hq.b3")
    for stage in ("hq.polish", "hq.quantize", "hq.error_image"):
        assert len(named(spans, stage)) == 1, stage
    (err,) = named(spans, "hq.error_image")
    assert len(inside(spans, err, "hq.scielab")) == 2


def test_single_engine_calls_progress_inside_a_span(tmp_path):
    q = HybridQuantizer(CFG, device="cpu")
    img = natural_image(24, 28, seed=3)
    spans = profiled(tmp_path, lambda: q.find_palette(img, progress=lambda *a: True))
    (fp,) = named(spans, "hq.find_palette")
    progress = inside(spans, fp, "hq.progress")
    chunks = inside(spans, fp, "hq.anneal.chunk")
    assert len(progress) == len(chunks) == 2
    # the callback runs after its chunk, outside it
    assert all(c[2] <= p[1] for c, p in zip(chunks, progress))


def test_run_bucketed_spans_one_bucket_each(tmp_path):
    images = [natural_image(h, w, seed=i) for i, (h, w) in enumerate([(8, 10), (6, 7), (8, 10), (5, 5)])]
    spans = profiled(tmp_path, lambda: run_bucketed(images, lambda stack: (stack * 2, stack.sum(axis=(1, 2, 3)))))
    buckets = named(spans, "hq.bucket")
    assert len(buckets) == 3
    for b in buckets:
        assert len(inside(spans, b, "hq.bucket.stack")) == 1
        assert len(inside(spans, b, "hq.bucket.scatter")) == 1


def test_batch_engine_spans(tmp_path):
    images = np.stack([natural_image(20, 24, seed=s) for s in range(3)])
    q = BatchQuantizer(CFG, device="cpu")

    def fn():
        out, _ = q.run(images, seeds=[1, 2, 3], progress=lambda *a: True, polish_iters=2)
        q.error_images(images, out)

    spans = profiled(tmp_path, fn)
    (fp,) = named(spans, "hq.batch.find_palettes")
    assert len(inside(spans, fp, "hq.context")) == 3  # one context an image
    for child in ("hq.seeding", "hq.init"):
        assert len(inside(spans, fp, child)) == 1, child
    assert len(inside(spans, fp, "hq.anneal.chunk")) == len(inside(spans, fp, "hq.progress")) == 2
    assert len(inside(spans, fp, "hq.anneal.step")) == 12
    (polish,) = named(spans, "hq.batch.polish")
    assert inside(spans, polish, "hq.b3")
    assert len(named(spans, "hq.batch.quantize")) == 1
    (err,) = named(spans, "hq.batch.error_images")
    assert len(inside(spans, err, "hq.error_image")) == 3
    assert len(inside(spans, err, "hq.scielab")) == 6


@pytest.mark.parametrize("source", ["numpy", "host tensor", "float64 numpy"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_upload_span_only_for_a_copy_off_the_host(tmp_path, source, device):
    img = natural_image(6, 8, seed=0)
    x = {"numpy": img, "host tensor": torch.from_numpy(img), "float64 numpy": img.astype(np.float64)}[source]
    out = []
    spans = profiled(tmp_path, lambda: out.append(as_image(x, device)))
    assert out[0].dtype == torch.float32 and out[0].device.type == device
    assert tuple(out[0].shape) == img.shape
    assert len(named(spans, "hq.upload")) == (device != "cpu")
    if device == "cpu":
        np.testing.assert_array_equal(out[0].numpy(), img)
