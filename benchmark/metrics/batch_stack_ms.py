"""batch_stack_ms: host time in the program's `hq.bucket.stack` and
`hq.bucket.scatter` spans (`batching.run_bucketed`: the `np.stack` of
each bucket's host images, the copy of its results into their slots),
summed, per job."""

from benchmark.program import count, host_ms


def read(data):
    ms, jobs = host_ms(data, "hq.bucket.stack", "hq.bucket.scatter"), count(data, "job")
    return ms / jobs if ms is not None and jobs else None
