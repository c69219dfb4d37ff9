"""Reductions of a traced run that the per-layer readers share.

Each reader (`metrics/<name>.py`) states what is particular to it (the
span it reads, the kernel names it matches, the counts it is held to)
and calls one of these. A reader that finds nothing to read returns None,
and the metric is left out of the result.
"""

from __future__ import annotations

import re

from . import roofline
from .tracing import TraceData, union_seconds


def _dur_ms(spans) -> list[float]:
    return [(s["te"] - s["ts"]) / 1e3 for s in spans]


def mean_span_ms(data: TraceData, name: str) -> float | None:
    """The mean duration of the spans called `name`."""
    d = _dur_ms(data.spans_named(name))
    return sum(d) / len(d) if d else None


def span_ms_per_job(data: TraceData, name: str) -> float | None:
    """The spans called `name`, summed, over the jobs traced."""
    d, jobs = _dur_ms(data.spans_named(name)), len(data.spans_named("job"))
    return sum(d) / jobs if d and jobs else None


def idle_share(data: TraceData) -> float:
    """The % of the traced window in which no device operation ran."""
    return 100.0 * (1.0 - union_seconds(data.device, *data.window) / data.window_s)


def launches_per_iteration(data: TraceData, span: str) -> float | None:
    """Kernel launch calls the host made between the first and the last
    progress mark of each `span`, over the iterations between them."""
    launches = iterations = 0
    for s in data.spans_named(span):
        marks = [m for m in data.marks if s["ts"] <= m["ts"] <= s["te"]]
        if len(marks) < 2:
            continue
        launches += data.launches_in(marks[0]["ts"], marks[-1]["ts"])
        iterations += marks[-1]["done"] - marks[0]["done"]
    return launches / iterations if iterations and launches else None


def roofline_share(data: TraceData, span: str, kernels: re.Pattern, counts) -> float | None:
    """% of its roofline bound that a fitness kernel reaches inside the
    spans called `span`: the bound of every evaluation (the initial one and
    one an iteration; `counts(span)` the operations and bytes of one) over
    the device time of the kernels matching `kernels`."""
    bound = busy = 0.0
    for s in data.spans_named(span):
        ops = data.device_in(s["ts"], s["te"], kernels)
        if not ops:
            continue
        busy += sum(te - ts for ts, te, *_ in ops) / 1e6
        bound += (s["iterations"] + 1) * roofline.bound_seconds(counts(s))
    return 100.0 * bound / busy if busy else None


def kernel_pattern(*names: str) -> re.Pattern:
    """Kernels of the program named `names`: at the start of the name,
    after `void ` or in an anonymous namespace, never in another one."""
    return re.compile(r"(^|void |\(anonymous namespace\)::)(" + "|".join(names) + r")[<(]")
