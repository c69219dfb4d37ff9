"""Observability: spans at the program's layer boundaries, profiler hooks.

The counterpart of `hybridquantization_tpu/metrics.py`. The reference's
observability was stdout wall-clock labels (HybridQuantization.addPerfLabel,
HybridQuantization.java:259-263) and an every-10-iterations ETA
(ImageManipulation.java:546-551). Here a `span` marks each layer boundary
(the context, the seeding, an anneal step, a kernel wrapper, a bucket) as a
profiler range named `hq.<name>`, so that it lies on the profiler's clock
beside the CUDA kernel and memcpy events it caused; `profiler_trace`
records such a trace (host and, on a card, CUDA activity) as a Chrome
trace. PyTorch returns before the card finishes, so
`synchronize` stands where the JAX package calls `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _profiler

#: the span of a run no profiler records: entering and leaving it does nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one stage of the program.

    With no `torch.profiler` recording it is a shared no-op: one check of
    the profiler's flag, no torch op, no allocation, no synchronization.
    While one records, it is a range named `hq.<name>` (torch's fast
    record-function scope, without `record_function`'s dispatcher calls:
    in a Chrome trace a "cpu_op" event beside the host's aten ops); the
    span that encloses it on the host thread is its parent. It never waits
    for the device: the device work a span caused is the work launched or
    enqueued inside it (in the trace, the CUDA call of the same
    correlation id).
    """
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast("hq." + name)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Record a torch.profiler trace around a region into
    `logdir/trace.json` (Chrome trace format; no-op when logdir is None).
    CUDA activity is recorded when a card is present."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def synchronize() -> None:
    """Wait for all queued work on the current CUDA device (if there is one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
