"""Seconds of the program's ``front.wav`` (the 16-bit WAV's encode) and
``front.b64`` (its base64 and the data URL's join) spans together, the
median per upload over the window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("front.wav", "front.b64"),
                          program.seconds_of("front.wav", "front.b64"))
