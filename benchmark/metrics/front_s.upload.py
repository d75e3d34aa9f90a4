"""Seconds of an upload's reply outside the engine's render: from the
process_file message to its file_processed reply, less the span around
AudioEngine.process_file_array (WAV decode and encode, base64, the
analysis, the JSON); the median over the window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

import statistics


def read(obs):
    spans = obs["spans"]
    pairs = list(zip(spans.get("reply_s", ()), spans.get("render_s", ())))
    return statistics.median(r - e for r, e in pairs) if pairs else None
