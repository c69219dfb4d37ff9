"""Observability: stage timers, throughput counters, profiler hooks.

The counterpart of `hybridquantization_tpu/metrics.py`. The reference's
observability was stdout wall-clock labels (HybridQuantization.addPerfLabel,
HybridQuantization.java:259-263) and an every-10-iterations ETA
(ImageManipulation.java:546-551). StageTimer keeps that style of label;
Throughput counts Mpix/s and iterations/s; `profiler_trace` records a
`torch.profiler` trace (host and, on a card, CUDA kernels) as a Chrome
trace. PyTorch returns before the card finishes, so `synchronize` stands
where the JAX package calls `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class StageTimer:
    """Named stage wall-clock labels (addPerfLabel parity). Time work on a
    card only up to a `synchronize()` inside the stage."""

    verbose: bool = True
    stages: dict = field(default_factory=dict)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            elapsed = time.time() - start
            self.stages[name] = self.stages.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"{name} : {elapsed * 1000:.0f}ms")

    def total(self) -> float:
        return time.time() - self._t0


@dataclass
class Throughput:
    """Megapixels/s and iterations/s counters."""

    pixels: int = 0
    iterations: int = 0
    seconds: float = 0.0

    def add(self, pixels: int, iterations: int, seconds: float) -> None:
        self.pixels += pixels
        self.iterations += iterations
        self.seconds += seconds

    @property
    def mpix_per_s(self) -> float:
        return self.pixels / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def iters_per_s(self) -> float:
        return self.iterations / self.seconds if self.seconds else 0.0


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


def timeit(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall-clock seconds of fn(*args), each call synchronized."""
    for _ in range(warmup):
        fn(*args)
        synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
