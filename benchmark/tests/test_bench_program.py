"""The program's own spans in a trace (`hq.` ranges, "cpu_op" events): the
readers of the harness's spans do not see them, `breakdown` names the
host's side of an idle gap by them, and the readers of `program.py`
compute their metrics from them and from the launches matched in order."""

from __future__ import annotations

import json

import pytest

from benchmark import cells, program
from benchmark.tracing import Tracer, breakdown, read_chrome_trace

SINGLE = {"pixels": 1000, "images": 1, "colors": 8, "population": 4, "precision": "f32x3", "iterations": 20}
BATCH = dict(SINGLE, pixels=500, images=2)
B1 = "void (anonymous namespace)::assign_pop_kernel<false>(float const*)"
B2 = "void (anonymous namespace)::fused_kernel<21, 0, false>(float const*)"
B3 = "void (anonymous namespace)::b3_kernel<true>(float const*)"
EW = "void at::native::vectorized_elementwise_kernel<4>(x)"
DTOH, HTOD = "Memcpy DtoH (Device -> Pageable)", "Memcpy HtoD (Pageable -> Device)"

#: the harness's spans (µs), in the tracer's order
HARNESS = [("job", 10, 1990, {}), ("find_palette", 100, 900, SINGLE), ("error_image", 900, 990, {}),
           ("find_palettes", 1000, 1800, BATCH), ("error_images", 1800, 1900, {})]
#: the program's spans: a find_palette, an error image, then a bucket of a batch
PROGRAM = [("find_palette", 110, 880), ("context", 120, 200), ("seeding", 200, 258), ("init", 260, 280),
           ("anneal.chunk", 280, 580), ("anneal.step", 290, 390), ("anneal.step", 390, 490),
           ("anneal.readback", 490, 570), ("progress", 585, 615), ("anneal.chunk", 620, 870),
           ("anneal.step", 630, 728), ("anneal.readback", 730, 860), ("error_image", 905, 985),
           ("scielab", 910, 950), ("bucket", 995, 1960), ("bucket.stack", 996, 999),
           ("batch.find_palettes", 1005, 1790), ("upload", 1010, 1040), ("batch.error_images", 1805, 1890),
           ("bucket.scatter", 1910, 1950)]
#: device operations (ts, te, name, cat, correlation) and the host call of each (name, ts)
DEVICE = [
    ((140, 180, EW, "kernel", 1), ("cudaLaunchKernel", 125)),          # the context
    ((215, 250, B3, "kernel", 2), ("cudaLaunchKernel", 205)),          # the seeding
    ((265, 300, B1, "kernel", 3), ("cudaLaunchKernel", 262)),          # init
    ((300, 340, B1, "kernel", 4), ("cudaLaunchKernel", 295)),          # step 1
    ((340, 380, B2, "kernel", 5), ("cudaLaunchKernel", 300)),
    ((395, 420, B1, "kernel", 6), ("cudaLaunchKernel", 392)),          # step 2
    ((420, 450, B2, "kernel", 7), ("cudaLaunchKernel", 395)),
    ((500, 510, DTOH, "gpu_memcpy", 8), ("cudaMemcpyAsync", 495)),     # readback
    ((640, 660, B1, "kernel", 9), ("cudaLaunchKernel", 635)),          # step 3
    ((660, 700, B2, "kernel", 10), ("cudaLaunchKernel", 640)),
    ((740, 750, DTOH, "gpu_memcpy", 11), ("cudaMemcpyAsync", 735)),    # readback
    ((915, 945, EW, "kernel", 12), ("cudaLaunchKernel", 912)),         # error image
    ((1015, 1035, HTOD, "gpu_memcpy", 13), ("cudaMemcpyAsync", 1012)),  # upload
    ((1100, 1300, B1, "kernel", 14), ("cudaLaunchKernel", 1090)),      # the bucket's anneal
    ((1300, 1500, B2, "kernel", 15), ("cudaLaunchKernel", 1095)),
    ((1810, 1850, EW, "kernel", 16), ("cudaLaunchKernel", 1806)),      # error images
    ((1960, 1970, EW, "kernel", 17), ("cudaLaunchKernel", 1952)),      # after the scatter
]
NEW = ("context_ms", "seeding_ms", "anneal_step_host_us", "anneal_idle_share", "batch_stack_ms", "batch_upload_ms")
OLD = ("find_palette_ms", "error_image_ms", "batch_find_palettes_ms", "batch_error_images_ms",
       "anneal_launches_per_iter", "b1_roofline.single", "b1_roofline.batch", "b2_roofline.single",
       "b2_roofline.batch", "idle_share.single", "idle_share.batch")


def event(name, cat, ts, te, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": te - ts}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace(tmp_path, with_program: bool):
    tracer = Tracer(False)
    tracer.spans = [dict(attrs, name=name) for name, _, _, attrs in HARNESS]
    tracer.marks = [{"done": 10}, {"done": 20}]
    events = [event("bench.window", "user_annotation", 0, 2000),
              event("bench.mark.0", "user_annotation", 300, 301),
              event("bench.mark.1", "user_annotation", 600, 601),
              event("aten::copy_", "cpu_op", 1011, 1038),
              event("cudaStreamSynchronize", "cuda_runtime", 740, 860, corr=50)]
    events += [event(f"bench.span.{i}.{name}", "user_annotation", ts, te)
               for i, (name, ts, te, _) in enumerate(HARNESS)]
    for (ts, te, name, cat, corr), call in DEVICE:
        events += [event(name, cat, ts, te, corr), event(call[0], "cuda_runtime", call[1], call[1] + 2, corr)]
    if with_program:
        events += [event(f"hq.{name}", "cpu_op", ts, te) for name, ts, te in PROGRAM]
    events.reverse()  # the reader sorts
    path = tmp_path / f"trace_{with_program}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    data = read_chrome_trace(str(path), tracer)
    data.taps = 21
    return data, str(path)


def test_each_device_operation_is_matched_to_its_call_in_order(tmp_path):
    data, path = trace(tmp_path, True)
    calls = [call[1] for _, call in DEVICE]
    assert [d[:2] for d in data.device] == [d[0][:2] for d in DEVICE]
    assert program.launched(data) == calls
    assert program.correlated_calls(path) == calls
    assert [n for *_, n in sorted(data.host) if n.startswith("hq.")] == [f"hq.{n}" for n, *_ in PROGRAM]
    assert [s["name"] for s in data.spans] == [name for name, *_ in HARNESS]


def test_in_order_matching_keeps_each_kind_apart(tmp_path):
    data, _ = trace(tmp_path, True)
    # a memset enqueued first takes no kernel's or memcpy's place
    data.host.append((1, 2, "cudaMemsetAsync"))
    data.device.insert(0, (3, 4, "Memset (Device)", "gpu_memset"))
    assert program.launched(data) == [1] + [call[1] for _, call in DEVICE]


@pytest.mark.parametrize("metric", OLD)
def test_the_harness_readers_do_not_see_the_program_spans(tmp_path, metric):
    read = cells.reader(metric)
    without, with_ = read(trace(tmp_path, False)[0]), read(trace(tmp_path, True)[0])
    assert with_ == without
    assert without is not None


def test_breakdown_names_the_hosts_side_of_a_gap_by_the_program_span(tmp_path):
    gaps = dict(breakdown(trace(tmp_path, True)[0])["idle_gaps"])
    assert gaps == pytest.approx({
        "job/python": 170e-6, "find_palette/hq.context": 35e-6, "find_palette/hq.seeding": 15e-6,
        "find_palette/hq.anneal.step": 105e-6, "find_palette/hq.anneal.chunk": 130e-6,
        "find_palette/cudaStreamSynchronize": 165e-6, "error_image/hq.error_image": 70e-6,
        "find_palettes/hq.batch.find_palettes": 375e-6, "job/hq.bucket": 110e-6,
    })
    # without them the host ran "python" there
    assert dict(breakdown(trace(tmp_path, False)[0])["idle_gaps"])["find_palette/python"] == pytest.approx(
        (35 + 15 + 15 + 50 + 130 + 40) * 1e-6)


def test_gap_labels_name_every_gap_by_the_innermost_program_span(tmp_path):
    assert program.gap_labels(trace(tmp_path, True)[0]) == pytest.approx({
        "job": 170e-6, "hq.context": 35e-6, "hq.seeding": 15e-6, "hq.anneal.step": 105e-6,
        "hq.anneal.chunk": 130e-6, "hq.anneal.readback": 165e-6, "hq.error_image": 70e-6,
        "hq.batch.find_palettes": 375e-6, "hq.bucket": 110e-6,
    })


@pytest.mark.parametrize("metric, value", [
    ("context_ms", 0.040),                               # the context's kernel, one find_palette
    ("seeding_ms", 0.035),
    ("anneal_step_host_us", (100 + 100 + 98) / 3),
    ("anneal_idle_share", 100 * (1 - (165 + 70) / 550)),  # busy 165 of 300 and 70 of 250 µs
    ("batch_stack_ms", 0.003 + 0.040),                   # the stack and the scatter, one job
    ("batch_upload_ms", 0.020),                          # the HtoD copy the upload enqueued
])
def test_program_readers(tmp_path, metric, value):
    assert cells.reader(metric)(trace(tmp_path, True)[0]) == pytest.approx(value)
    assert cells.reader(metric)(trace(tmp_path, False)[0]) is None


def test_a_reader_needs_the_span_it_counts_per(tmp_path):
    data, _ = trace(tmp_path, True)
    data.host = [h for h in data.host if h[2] != "hq.find_palette"]
    assert cells.reader("context_ms")(data) is None
    assert program.caused_ms(data, "hq.upload", per="job") == pytest.approx(0.020)
    assert program.caused_ms(data, "hq.upload", per="job", copies="DtoH") == 0.0


def test_clock_checks(tmp_path):
    data, path = trace(tmp_path, True)
    correlated = program.correlated_calls(path)
    correlated[-1] = None                              # the last kernel's launch not recorded
    checks = program.clock_checks(data, correlated)
    assert checks.pop("enqueued") == {"kernel": [14, 14], "gpu_memcpy": [3, 3], "gpu_memset": [0, 0]}
    assert checks.pop("unlike_in_order") == {EW: 1}
    assert checks == pytest.approx({
        "find_palette_nested": [1, 1],
        "matched_device_share": 815 / 825,
        "in_order_matching_share": 815 / 825,
        "find_palette_parts_over_spans": 1.0,          # context, seeding, init and the chunks: all of it
        "engine_idle_named_share": 1.0,
        "breakdown_idle_named_share": (895 - 165) / 895,  # but for the gap in a runtime call
        "job_idle_s_per_job": 170e-6,
        "window_s_per_job": 2000e-6,
    })
    assert program.clock_checks(data)["matched_device_share"] is None


@pytest.mark.parametrize("extra, silent", [
    # a kernel with no launch call of its own, as a CUDA graph's are, before the window or after it
    ((-50, -40, EW, "kernel"), {"context_ms", "seeding_ms"}),
    ((2100, 2110, EW, "kernel"), {"context_ms", "seeding_ms"}),
    # a copy's call whose copy the profiler did not record
    ((1500, 1502, "cudaMemcpyAsync"), {"context_ms", "seeding_ms", "batch_upload_ms"}),
])
def test_a_kind_whose_calls_and_operations_differ_in_number_is_not_matched(tmp_path, extra, silent):
    data, _ = trace(tmp_path, True)
    readings = {m: cells.reader(m)(data) for m in ("context_ms", "seeding_ms", "batch_upload_ms")}
    if len(extra) == 4:
        data.device = sorted(data.device + [extra])
    else:
        data.host.append(extra)
    unmatched = {d[3] for d, t in zip(data.device, program.launched(data)) if t is None}
    assert unmatched == {"kernel"} if len(extra) == 4 else unmatched == {"gpu_memcpy"}
    for metric, value in readings.items():
        assert cells.reader(metric)(data) == (None if metric in silent else pytest.approx(value))


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert program.main(["--workload", "single_4k.quality", "--seed", "1"]) == 2


def test_main_gives_the_harness_its_trace_reader_back(monkeypatch):
    from benchmark import harness, tracing

    read = tracing.read_chrome_trace

    def run(*_):
        assert tracing.read_chrome_trace is not read
        raise RuntimeError("the run failed")

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr(harness, "Run", run)
    with pytest.raises(RuntimeError, match="the run failed"):
        program.main(["--workload", "single_4k.quality", "--seed", "1"])
    assert tracing.read_chrome_trace is read


def test_every_new_metric_is_in_the_benchmark():
    spec = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {p["name"]: p for p in spec["per_layer"]}
    assert [p["name"] for p in spec["per_layer"]][-len(NEW):] == list(NEW)
    for name in NEW:
        assert entries[name]["source"] == "program_span"
        for cell in entries[name]["workloads"]:
            assert name in {m.name for m in cells.load(cell).per_layer}
