"""Seconds of the program's ``front.decode`` span (the upload's data URL
to float32 samples, on the loop's thread), the median over the window's
uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("front.decode",), program.seconds_of("front.decode"))
