"""context_ms: device time of the operations the program's `hq.context`
spans caused (`pipeline._make_context`: the target's S-CIELAB transform,
the filter stacks, the assignment features), per `hq.find_palette`."""

from benchmark.program import caused_ms


def read(data):
    return caused_ms(data, "hq.context", per="hq.find_palette")
