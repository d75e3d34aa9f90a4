"""The 99th percentile, over every due block of the window, of the time
from its due time to when the client held its output, in a cell whose
mic-path call does not fit the block period: there it follows the call
time (about three calls), so it is read here and not bounded."""

LAYER = "client (the benchmark's load generator)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "stream_x_realtime"


def read(obs):
    return obs["counters"].get("block_p99_ms")
