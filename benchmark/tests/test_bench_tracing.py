"""Reading a trace: the busy union, the idle share, launches, rooflines."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import cells, layers, roofline
from benchmark.tracing import Tracer, breakdown, idle_gaps, read_chrome_trace, union_seconds


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic(tmp_path):
    """A window of 1000 µs: one find_palette span with marks at iterations
    10 and 20, kernels of B1 and B2 and others, a memcpy, launches."""
    tracer = Tracer(False)
    tracer.spans = [{"name": "find_palette", "pixels": 1000, "images": 1, "colors": 8,
                     "population": 4, "precision": "f32x3", "iterations": 20},
                    {"name": "job"}]
    tracer.marks = [{"done": 10}, {"done": 20}]
    b1 = "void (anonymous namespace)::assign_pop_kernel<true>(float const*, int)"
    b2 = "void (anonymous namespace)::fused_kernel<0, false>(float const*)"
    events = [
        event("bench.window", "user_annotation", 0, 1000),
        event("bench.span.0.find_palette", "user_annotation", 100, 700),
        event("bench.span.1.job", "user_annotation", 50, 900),
        event("bench.mark.0", "user_annotation", 300, 1),
        event("bench.mark.1", "user_annotation", 600, 1),
        event(b1, "kernel", 150, 100),          # busy 150-250
        event(b2, "kernel", 200, 100),          # overlaps: busy 150-300
        event("void at::native::reduce_kernel<512, 1>(x)", "kernel", 400, 50),  # 400-450
        event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 900, 200),      # clipped to 900-1000
        event("cudaLaunchKernel", "cuda_runtime", 310, 5),
        event("cudaLaunchKernel", "cuda_runtime", 320, 5),
        event("cuLaunchKernelEx", "cuda_driver", 590, 5),
        event("cudaLaunchKernel", "cuda_runtime", 700, 5),  # after the last mark
        event("aten::item", "cpu_op", 460, 300),
        event("cudaStreamSynchronize", "cuda_runtime", 470, 200),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path), tracer)


def test_busy_union_and_idle_share(tmp_path):
    data = synthetic(tmp_path)
    busy = union_seconds(data.device, *data.window)
    assert busy == pytest.approx((150 + 50 + 100) / 1e6)
    assert layers.idle_share(data) == pytest.approx(100 * (1 - 300 / 1000))
    assert idle_gaps(data) == [(0, 150), (300, 400), (450, 900)]


def test_breakdown_names_device_ops_and_what_the_host_did_in_gaps(tmp_path):
    b = breakdown(synthetic(tmp_path))
    ops = dict(b["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(100 / 1e6)  # inside the window only
    gaps = dict(b["idle_gaps"])
    # each gap goes by its middle: (450, 900) to the aten::item holding 675
    assert gaps == pytest.approx({"find_palette/aten::item": 450e-6, "find_palette/python": 100e-6,
                                  "job/python": 150e-6})


def test_launches_between_the_marks_over_the_iterations(tmp_path):
    data = synthetic(tmp_path)
    assert layers.launches_per_iteration(data, "find_palette") == pytest.approx(3 / 10)


def test_roofline_share_holds_the_kernels_to_their_counts(tmp_path):
    data = synthetic(tmp_path)
    b1 = cells.reader("b1_roofline.single")
    bound = 21 * roofline.bound_seconds(roofline.b1_counts(1000, 8, 4, "fp32"))
    assert b1(data) == pytest.approx(100 * bound / 100e-6)
    data.taps = 21
    b2 = cells.reader("b2_roofline.single")(data)
    assert b2 == pytest.approx(100 * 21 * roofline.bound_seconds(roofline.b2_counts(1000, 4, 21, "fp32")) / 100e-6)
    # torch's own reduce_kernel is no kernel of B2
    assert not layers.kernel_pattern("reduce_kernel").search("void at::native::reduce_kernel<512, 1>(x)")
    assert cells.reader("b1_roofline.batch")(data) is None  # no find_palettes span: nothing to read


def test_span_readers(tmp_path):
    data = synthetic(tmp_path)
    assert cells.reader("find_palette_ms")(data) == pytest.approx(0.7)
    assert cells.reader("error_image_ms")(data) is None


def test_tracer_records_spans_and_marks_in_a_profile():
    from benchmark.tracing import profiled

    tracer, out = Tracer(True), {}
    with profiled(tracer, out):
        with tracer.span("find_palette", iterations=2) as span:
            torch.ones(64).sum()
            tracer.mark(done=1)
            span["extra"] = 1
    data = out["trace"]
    (s,) = data.spans_named("find_palette")
    assert s["iterations"] == 2 and s["extra"] == 1
    assert data.window[0] <= s["ts"] <= s["te"] <= data.window[1]
    assert [m["done"] for m in data.marks] == [1]
