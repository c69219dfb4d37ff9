"""batch_find_palettes_ms: the spans around `BatchQuantizer.find_palettes`
(each bucket's contexts, seeding and lockstep anneal) inside `run`,
summed over a job's buckets, per job."""

from benchmark.layers import span_ms_per_job


def read(data):
    return span_ms_per_job(data, "find_palettes")
