"""batch_upload_ms: device time of the host-to-device copies the
program's `hq.upload` spans enqueued (`pipeline.as_image`: each stage of
`BatchQuantizer` uploads the bucket's host stack), summed, per job."""

from benchmark.program import caused_ms


def read(data):
    return caused_ms(data, "hq.upload", per="job", copies="HtoD")
