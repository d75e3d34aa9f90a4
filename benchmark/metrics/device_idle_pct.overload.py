"""As device_idle_pct.stream, in a cell whose mic-path call does not fit
the block period, where it moves stream_x_realtime."""

LAYER = "device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "stream_x_realtime"

from benchmark.harness import load_reader

read = load_reader("device_idle_pct.stream").read
