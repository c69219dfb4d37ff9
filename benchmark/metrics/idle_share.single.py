"""idle_share.single: the % of the traced window (whole jobs) in which no
kernel, memcpy or memset ran on the device."""

from benchmark.layers import idle_share


def read(data):
    return idle_share(data)
