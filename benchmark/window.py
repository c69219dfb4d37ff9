"""The measured window's arithmetic.

The window runs a closed loop with one client and closes at the first
boundary of work at or after its length: an image, a chunk of anneal
iterations (the image in flight then counts by the share of its
iterations done), or a bucket of a batch. Every rate divides all the work
done by the whole elapsed time; a tail is taken over every image that
finished.
"""

from __future__ import annotations

import math
import time


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Window:
    """Work and time of one measured window."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.clock = clock
        self.start = clock()
        self.deadline = self.start + seconds
        self.end: float | None = None
        self.images = 0.0          # finished images, plus the in-flight share
        self.pixels = 0            # pixels of finished images
        self.image_seconds: list[float] = []
        self.job_seconds: list[float] = []   # every finished job's own time, for the log

    def due(self) -> bool:
        return self.clock() >= self.deadline

    def finished(self, seconds: float | None, pixels: int, images: int = 1) -> None:
        """Images that finished; `seconds` is an image's own time (None for
        work that is not one image, as a bucket of a batch)."""
        self.images += images
        self.pixels += pixels
        if seconds is not None:
            self.image_seconds.append(seconds)

    def partial(self, share: float) -> None:
        """The image in flight when the window closed, by its share done."""
        self.images += share

    def close(self) -> float:
        self.end = self.clock()
        return self.elapsed

    @property
    def elapsed(self) -> float:
        return (self.end if self.end is not None else self.clock()) - self.start

    def seconds_per_image(self) -> float:
        return self.elapsed / self.images

    def mpix_per_s(self) -> float:
        return self.pixels / 1e6 / self.elapsed

