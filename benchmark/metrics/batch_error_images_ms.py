"""batch_error_images_ms: the spans around `BatchQuantizer.error_images`,
summed over a job's buckets, per job."""

from benchmark.layers import span_ms_per_job


def read(data):
    return span_ms_per_job(data, "error_images")
