"""find_palette_ms: the mean span around `HybridQuantizer.find_palette`
(context, k-means seeding and anneal), per image, in the traced run."""

from benchmark.layers import mean_span_ms


def read(data):
    return mean_span_ms(data, "find_palette")
