"""Seconds of the span around AudioEngine.process_file_array (the fresh
chain's whole-file render), the median over the window's uploads."""

LAYER = "engine (engine/engine.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

import statistics


def read(obs):
    spans = obs["spans"].get("render_s", ())
    return statistics.median(spans) if spans else None
