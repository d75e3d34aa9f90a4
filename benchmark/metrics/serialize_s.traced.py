"""Seconds of the program's ``front.serialize`` span (the reply's WAV,
base64 and JSON text, on an executor's worker), the median over the
window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("front.serialize",), program.seconds_of("front.serialize"))
