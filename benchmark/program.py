"""Readings of the program's own spans in a traced run.

The port records a span at each layer boundary (`metrics.span`: a range
named `hq.<name>` on the profiler's clock that never synchronizes; in the
Chrome trace a "cpu_op" event). The harness's trace reader keeps such
events among the host operations (`TraceData.host`), where the readers
below find them; each returns None where the trace holds none of the
spans it reads, as a program without them leaves it.

A device operation is caused by a span when the host call that launched
or enqueued it lies inside the span. The trace data keeps no correlation
ids, so calls and device operations are matched in order, kind by kind
(the n-th kernel launch to the n-th kernel, the n-th memcpy call to the
n-th memcpy), as the one stream the port uses runs them. A kind whose
calls and operations differ in number is not matched at all, and the
readers that need it return None: a launch the profiler missed, or the
kernels of a CUDA graph (launched by one `cudaGraphLaunch`), would shift
every later pair.

`main` is a manual tool for a card, to be deleted once the harness's
trace reader keeps the correlation ids:

    python3 benchmark/program.py --workload <cell> --seed <n>

traces the cell's jobs as `run.py --trace 1` does and holds the in-order
matching to the trace's correlation ids, and the spans to the device
trace's clock.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.tracing import DEVICE_CATS, LAUNCH, TraceData, _innermost, idle_gaps  # noqa: E402

PREFIX = "hq."
#: the host calls that enqueue each kind of device operation
ENQUEUE_CALLS = {"kernel": LAUNCH, "gpu_memcpy": re.compile(r"^cu(da)?Memcpy"),
                 "gpu_memset": re.compile(r"^cu(da)?Memset")}
#: the harness's spans around the calls into the engine
ENGINE_CALLS = ("find_palette", "find_palettes", "polish", "quantize", "error_image", "error_images")
#: the children of `hq.find_palette` that launch its device work
FIND_PALETTE_PARTS = ("hq.context", "hq.seeding", "hq.init", "hq.anneal.chunk")


def spans(data: TraceData, name: str) -> list[tuple[float, float]]:
    """(ts, te) of the program's spans called `name` (`hq.` included)."""
    return [(ts, te) for ts, te, n in data.host if n == name]


def count(data: TraceData, name: str) -> int:
    """The spans called `name`: the program's (`hq.` names) or the harness's."""
    return len(spans(data, name)) if name.startswith(PREFIX) else len(data.spans_named(name))


def enqueued(data: TraceData) -> dict[str, tuple[int, int]]:
    """For each kind of device operation: (host calls, operations)."""
    return {cat: (sum(bool(rx.search(name)) for *_, name in data.host), sum(d[3] == cat for d in data.device))
            for cat, rx in ENQUEUE_CALLS.items()}


def launched(data: TraceData) -> list[float | None]:
    """For each of `data.device`, in its order: the host ts of the call that
    launched or enqueued it, matched in order within its kind; None for
    every operation of a kind whose calls and operations differ in number."""
    matched = {cat for cat, (calls, ops) in enqueued(data).items() if calls == ops}
    calls = {cat: sorted(ts for ts, _, name in data.host if rx.search(name)) if cat in matched else []
             for cat, rx in ENQUEUE_CALLS.items()}
    seen = dict.fromkeys(DEVICE_CATS, 0)
    out = []
    for *_, cat in data.device:
        i, seen[cat] = seen[cat], seen[cat] + 1
        out.append(calls[cat][i] if i < len(calls[cat]) else None)
    return out


def _merged(intervals) -> list[tuple[float, float]]:
    """The union of (ts, te, ...) intervals as sorted disjoint (lo, hi)."""
    out: list[list[float]] = []
    for ts, te, *_ in sorted(intervals):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], te)
        else:
            out.append([ts, te])
    return [(a, b) for a, b in out]


def _inside(merged, t: float) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def caused(data: TraceData, *names: str, at: list | None = None) -> list[tuple]:
    """The device operations launched or enqueued while the host was inside a
    program span of one of `names`; `at` gives each operation's call (by
    default `launched(data)`)."""
    within = _merged(s for n in names for s in spans(data, n))
    return [d for d, t in zip(data.device, at or launched(data)) if t is not None and _inside(within, t)]


def caused_ms(data: TraceData, name: str, per: str, copies: str | None = None) -> float | None:
    """Device ms of the operations the spans `name` caused (only the
    memcpys whose name holds `copies`, where given), over the number of
    spans `per`; None without either span, or where an operation of a kind
    it reads is matched to no call."""
    n = count(data, per)
    if not n or not spans(data, name):
        return None
    at = launched(data)
    kinds = ("gpu_memcpy",) if copies is not None else DEVICE_CATS
    if any(t is None and d[3] in kinds for d, t in zip(data.device, at)):
        return None
    ops = caused(data, name, at=at)
    if copies is not None:
        ops = [d for d in ops if d[3] == "gpu_memcpy" and copies in d[2]]
    return sum(te - ts for ts, te, *_ in ops) / 1e3 / n


def host_ms(data: TraceData, *names: str) -> float | None:
    """Host ms in the program's spans of `names`, summed; None without any."""
    d = [te - ts for n in names for ts, te in spans(data, n)]
    return sum(d) / 1e3 if d else None


def idle_share_in(data: TraceData, name: str) -> float | None:
    """The % of the spans `name`'s time in which no device operation ran."""
    within = spans(data, name)
    total = sum(te - ts for ts, te in within)
    if not total:
        return None
    busy = _merged(data.device)
    cum = [0.0]
    for a, b in busy:
        cum.append(cum[-1] + b - a)

    def upto(t: float) -> float:  # busy µs before t
        i = bisect.bisect_right(busy, (t, float("inf")))
        return cum[i - 1] + min(busy[i - 1][1], t) - busy[i - 1][0] if i else 0.0

    return 100.0 * (1.0 - sum(upto(te) - upto(ts) for ts, te in within) / total)


def _program_at(data: TraceData, points) -> list[str | None]:
    """The innermost program span holding each of the sorted `points`."""
    return _innermost([h for h in data.host if h[2].startswith(PREFIX)], points)


def gap_labels(data: TraceData) -> dict[str, float]:
    """Idle seconds of the window by the innermost program span holding each
    gap's middle, else by the harness's span. (`breakdown` labels a gap by
    the harness's span and the innermost host range: the program span where
    the host ran Python, the aten op where it was in one.)"""
    gaps = idle_gaps(data)
    mids = [(a + b) / 2 for a, b in gaps]
    harness = _innermost([(s["ts"], s["te"], s["name"]) for s in data.spans], mids)
    out: dict[str, float] = {}
    for (a, b), p, h in zip(gaps, _program_at(data, mids), harness):
        label = p or h or "between spans"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def clock_checks(data: TraceData, correlated: list | None = None) -> dict:
    """Whether the program's spans share the device trace's clock, and the
    share of the engine calls' idle time that a program span names, by
    `gap_labels` and by `breakdown`. With `correlated` (each device
    operation's call by correlation id), the shares of device time matched
    to a call and matched alike in order."""
    outer = data.spans_named("find_palette")
    inner = spans(data, "hq.find_palette")
    nested = sum(any(o["ts"] <= ts and te <= o["te"] for o in outer) for ts, te in inner)
    parts = sum(te - ts for ts, te, *_ in caused(data, *FIND_PALETTE_PARTS, at=correlated))
    in_outer = sum(te - ts for s in outer for ts, te, *_ in data.device_in(s["ts"], s["te"]))
    engine = _merged((s["ts"], s["te"]) for n in ENGINE_CALLS for s in data.spans_named(n))
    gaps = idle_gaps(data)
    mids = [(a + b) / 2 for a, b in gaps]
    idle = named = breakdown_named = 0.0
    # `breakdown` names a gap by the innermost host range, a program span or not
    for (a, b), p, h in zip(gaps, _program_at(data, mids), _innermost(data.host, mids)):
        if _inside(engine, (a + b) / 2):
            idle += b - a
            named += (b - a) * (p is not None)
            breakdown_named += (b - a) * bool(h and h.startswith(PREFIX))
    lo, hi = data.window
    total = matched = alike = 0.0
    unlike: dict[str, int] = {}
    for d, c, f in zip(data.device, correlated or [None] * len(data.device), launched(data)):
        if lo <= d[0] and d[1] <= hi:
            total += d[1] - d[0]
            matched += (d[1] - d[0]) * (c is not None)
            alike += (d[1] - d[0]) * (c is not None and c == f)
            if correlated and c != f:
                unlike[d[2][:80]] = unlike.get(d[2][:80], 0) + 1
    jobs = count(data, "job") or 1
    return {
        "find_palette_nested": [nested, len(inner)],
        "enqueued": {cat: list(n) for cat, n in enqueued(data).items()},
        "matched_device_share": matched / total if correlated and total else None,
        "in_order_matching_share": alike / total if correlated and total else None,
        "unlike_in_order": unlike if correlated else None,
        "find_palette_parts_over_spans": parts / in_outer if in_outer else None,
        "engine_idle_named_share": named / idle if idle else None,
        "breakdown_idle_named_share": breakdown_named / idle if idle else None,
        "job_idle_s_per_job": gap_labels(data).get("job", 0.0) / jobs,
        "window_s_per_job": data.window_s / jobs,
    }


def correlated_calls(path: str) -> list[float | None]:
    """From a Chrome trace: for each device operation, in the order
    `tracing.read_chrome_trace` sorts them, the host ts of the CUDA API
    call of the same correlation id (None where none was recorded)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls: dict = {}
    device = []
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        ts = float(e["ts"])
        if e.get("cat") in DEVICE_CATS:
            device.append(((ts, ts + float(e.get("dur", 0.0)), e.get("name", ""), e["cat"]), corr))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            calls[corr] = min(ts, calls.get(corr, ts))
    return [calls.get(corr) for _, corr in sorted(device, key=lambda dc: dc[0])]


def main(argv=None) -> int:
    """Trace the cell's jobs on the card as `run.py --trace 1` does and print
    the checks, the per-layer metrics and the idle seconds by span as one
    JSON line."""
    p = argparse.ArgumentParser(description="Check the program's spans against the device trace.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells, checks, harness, tracing

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("program: no CUDA card", file=sys.stderr)
        return 2
    # the harness reads its Chrome trace and removes it: take the
    # correlation ids from it on the way
    correlated: list = []
    read = tracing.read_chrome_trace

    def reading(path, tracer):
        correlated.extend(correlated_calls(path))
        return read(path, tracer)

    tracing.read_chrome_trace = reading
    try:
        run = harness.Run(cell, args.seed, "cuda:0", tracing.Tracer(True))
        run.warm_up()
        data, _ = harness.traced(run, int(cell.traffic.get("trace_jobs", 1)))
    finally:
        tracing.read_chrome_trace = read
    data.cell, data.taps = cell, checks.Judge(cell.config, cell.traffic, "cpu").filters.taps
    out = {"cell": cell.name, "seed": args.seed, "device": "cuda:0",
           "checks": clock_checks(data, correlated if data.device else None),
           "metrics": {m.name: cells.reader(m.name)(data) for m in cell.per_layer},
           "idle_by_span": gap_labels(data)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
