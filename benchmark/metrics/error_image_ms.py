"""error_image_ms: the mean span around `HybridQuantizer.error_image`
(both S-CIELAB transforms and Delta-E), per image, in the traced run."""

from benchmark.layers import mean_span_ms


def read(data):
    return mean_span_ms(data, "error_image")
