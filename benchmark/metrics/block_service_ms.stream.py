"""The 99th percentile of the span around each mic-path call,
AudioEngine.process_stream_block_pipelined, over the window's calls."""

LAYER = "engine (engine/engine.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "block_p99_ms"

import numpy as np


def read(obs):
    spans = obs["spans"].get("block_service_s", ())
    return 1000.0 * float(np.percentile(spans, 99)) if len(spans) else None
