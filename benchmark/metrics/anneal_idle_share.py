"""anneal_idle_share: the % of the program's `hq.anneal.chunk` spans'
time (`swasa/loop.run_chunk`) in which no kernel, memcpy or memset ran:
the device waiting on the anneal's host side."""

from benchmark.program import idle_share_in


def read(data):
    return idle_share_in(data, "hq.anneal.chunk")
