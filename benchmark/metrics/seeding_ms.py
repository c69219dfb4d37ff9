"""seeding_ms: device time of the operations the program's `hq.seeding`
spans caused (`ops/kmeans.kmeans_init_palettes`: the colour histogram,
the weighted starts and the Lloyd steps of B3), per `hq.find_palette`."""

from benchmark.program import caused_ms


def read(data):
    return caused_ms(data, "hq.seeding", per="hq.find_palette")
