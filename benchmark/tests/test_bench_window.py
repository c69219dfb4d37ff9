"""The window's arithmetic: the in-flight share, the tail, the rates, and
the records the comparison is given."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark import harness
from benchmark.record import Record
from benchmark.window import Window, percentile


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_percentile_interpolates_like_numpy():
    np = pytest.importorskip("numpy")
    xs = [0.31, 0.27, 0.29, 0.35, 0.28, 0.30, 0.26, 0.33, 0.32, 0.40, 0.29]
    for q in (50, 90, 95, 99):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), abs=1e-12)
    assert percentile([2.0], 90) == 2.0


def test_rate_divides_all_the_work_by_the_elapsed_time():
    clock = Clock()
    w = Window(10.0, clock)
    for dt in (3.0, 4.0, 4.5):
        clock.t += dt
        w.finished(dt, pixels=2_000_000)
    assert w.due()
    w.close()
    assert w.elapsed == pytest.approx(11.5)
    assert w.seconds_per_image() == pytest.approx(11.5 / 3)
    assert w.mpix_per_s() == pytest.approx(6.0 / 11.5)
    assert percentile(w.image_seconds, 90) == pytest.approx(4.4)


def test_the_image_in_flight_counts_by_its_share():
    clock = Clock()
    w = Window(20.0, clock)
    clock.t += 9.0
    w.finished(9.0, pixels=1)
    clock.t += 11.2  # the window closes at the chunk boundary after 20 s
    w.partial(0.25)
    w.close()
    assert w.images == pytest.approx(1.25)
    assert w.seconds_per_image() == pytest.approx(20.2 / 1.25)
    assert w.image_seconds == [9.0]  # the tail takes finished images only


def test_buckets_count_as_work_without_a_time_of_their_own():
    clock = Clock()
    w = Window(5.0, clock)
    clock.t += 2.0
    w.finished(None, pixels=16 * 1920 * 1080, images=16)
    clock.t += 4.0
    w.finished(None, pixels=16 * 640 * 480, images=16)
    w.close()
    assert w.image_seconds == []
    assert w.mpix_per_s() == pytest.approx((16 * 1920 * 1080 + 16 * 640 * 480) / 1e6 / 6.0)


def test_the_comparison_gets_the_first_finished_job_of_each_image():
    class Run:
        batch = False
        cell = types.SimpleNamespace(traffic={"close_at": "job"})

        def job(self, n, stop, bucket_done):
            q = np.zeros((2, 3, 3), np.float32)
            return [Record(n % 2, q[0], float(n), q[0], q)], None

    w, records, attempted = harness.measure(Run(), 0.02)
    assert attempted >= 3 and w.images == attempted
    assert sorted((r.index, r.fitness) for r in records) == [(0, 0.0), (1, 1.0)]
