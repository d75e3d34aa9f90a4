"""As block_service_ms.stream, in a cell whose mic-path call does not fit
the block period, where it moves stream_x_realtime."""

LAYER = "engine (engine/engine.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "stream_x_realtime"

from benchmark.harness import load_reader

read = load_reader("block_service_ms.stream").read
