"""As kernels_per_step.stream, in a cell whose mic-path call does not fit
the block period, where it moves stream_x_realtime."""

LAYER = "chain (core/chain.py, core/packing.py)"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "stream_x_realtime"

from benchmark.harness import load_reader

read = load_reader("kernels_per_step.stream").read
