"""Spans around the program's public calls, and the reading of a
`torch.profiler` trace.

In a traced run the harness wraps each call into the program in a span
(`torch.profiler.record_function`, named `bench.span.<i>.<name>`), which
ends in a `synchronize()` so that the device work of the call lies inside
it; the progress callback of an anneal leaves a mark (`bench.mark.<i>`).
The attributes of span i and mark i (shapes, iterations) stay in the
harness. After the run the Chrome trace is read into a `TraceData`, which
the per-layer readers (`metrics/*.py`) take.

Device time is the union of the kernel, memcpy and memset intervals;
the idle share divides what is left of the traced window (the
`bench.window` range around the traced jobs) by the window's wall time.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^cu(da)?LaunchKernel|^cudaLaunchCooperativeKernel")
WINDOW = "bench.window"


class Tracer:
    """Spans and marks of a run; inactive ones cost nothing and sync nothing."""

    def __init__(self, active: bool):
        self.active = active
        self.spans: list[dict] = []
        self.marks: list[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.active:
            yield attrs
            return
        i = len(self.spans)
        self.spans.append(dict(attrs, name=name))
        with torch.profiler.record_function(f"bench.span.{i}.{name}"):
            yield self.spans[i]
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def mark(self, **attrs) -> None:
        if self.active:
            i = len(self.marks)
            self.marks.append(attrs)
            with torch.profiler.record_function(f"bench.mark.{i}"):
                pass


@dataclasses.dataclass
class TraceData:
    """What a traced run left, times in microseconds on the profiler's clock."""

    window: tuple[float, float]
    spans: list[dict]          # attrs + name, ts, te
    marks: list[dict]          # attrs + ts
    device: list[tuple]        # (ts, te, name, cat), sorted
    launches: list[float]      # ts of each kernel launch call on the host, sorted
    host: list[tuple]          # (ts, te, name) of host operations and runtime calls
    cell: object = None        # the Cell
    taps: int = 0              # the S-CIELAB filters' taps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def spans_named(self, name: str) -> list[dict]:
        return [s for s in self.spans if s["name"] == name]

    def device_in(self, ts: float, te: float, pattern: re.Pattern | None = None) -> list[tuple]:
        """Device operations that ran within [ts, te]; kernels whose name
        matches `pattern` only, where one is given."""
        first = bisect.bisect_left(self.device, (ts,))
        last = bisect.bisect_right(self.device, (te,))
        return [d for d in self.device[first:last] if d[1] <= te
                and (pattern is None or (d[3] == "kernel" and pattern.search(d[2])))]

    def launches_in(self, ts: float, te: float) -> int:
        return bisect.bisect_right(self.launches, te) - bisect.bisect_left(self.launches, ts)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of (ts, te, ...) intervals in µs."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for iv in sorted((max(i[0], lo), min(i[1], hi)) for i in intervals):
        a, b = iv
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy / 1e6


def idle_gaps(data: TraceData) -> list[tuple[float, float]]:
    """The stretches of the window in which no device operation ran."""
    lo, hi = data.window
    gaps, at = [], lo
    for ts, te, *_ in data.device:
        if te <= lo or ts >= hi:
            continue
        if ts > at:
            gaps.append((at, ts))
        at = max(at, te)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def _innermost(intervals, points):
    """For each of the sorted `points`, the name of the innermost of the
    nested (ts, te, name) `intervals` that holds it, or None: one sweep
    with a stack of the open intervals."""
    out, stack, i = [], [], 0
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    for t in points:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    window by what the host was doing, each the `top` largest."""
    lo, hi = data.window
    by_op: dict[str, float] = {}
    for ts, te, name, _ in data.device:
        inside = min(te, hi) - max(ts, lo)
        if inside > 0:
            by_op[name[:160]] = by_op.get(name[:160], 0.0) + inside / 1e6
    gaps = idle_gaps(data)
    mids = [(a + b) / 2 for a, b in gaps]
    spans = _innermost([(s["ts"], s["te"], s["name"]) for s in data.spans], mids)
    ops = _innermost(data.host, mids)
    by_gap: dict[str, float] = {}
    for (a, b), span, op in zip(gaps, spans, ops):
        label = f"{span or 'between spans'}/{op or 'python'}"
        by_gap[label] = by_gap.get(label, 0.0) + (b - a) / 1e6
    first = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": first(by_op), "idle_gaps": first(by_gap)}


def read_chrome_trace(path: str, tracer: Tracer) -> TraceData:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, marks, device, launches, host = [], [], [], [], []
    window = None
    for e in events:
        name, cat = e.get("name", ""), e.get("cat", "")
        ts = float(e["ts"])
        te = ts + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, te, name, cat))
        elif cat == "user_annotation" and name.startswith("bench."):
            parts = name.split(".")
            if name == WINDOW:
                window = (ts, te)
            elif parts[1] == "span":
                spans.append(dict(tracer.spans[int(parts[2])], ts=ts, te=te))
            elif parts[1] == "mark":
                marks.append(dict(tracer.marks[int(parts[2])], ts=ts))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((ts, te, name))
            if LAUNCH.search(name):
                launches.append(ts)
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return TraceData(window, sorted(spans, key=lambda s: s["ts"]), sorted(marks, key=lambda m: m["ts"]),
                     sorted(device), sorted(launches), host)


@contextlib.contextmanager
def profiled(tracer: Tracer, out: dict):
    """Profile the block; afterwards out["trace"] is its TraceData. The
    Chrome trace goes to a temporary file, removed once read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["trace"] = read_chrome_trace(path, tracer)
    finally:
        os.remove(path)
