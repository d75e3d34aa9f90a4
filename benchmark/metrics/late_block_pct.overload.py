"""As late_block_pct.stream, in a cell whose mic-path call does not fit the
block period, where it moves stream_x_realtime."""

LAYER = "client (the benchmark's load generator)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "stream_x_realtime"

from benchmark.harness import load_reader

read = load_reader("late_block_pct.stream").read
