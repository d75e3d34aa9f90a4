"""Seconds of the program's ``front.samples`` span (the C call's stretch
over the reply's two sample arrays, ``engine/jsonfmt.py:reply``), the
median over the window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("front.samples",), program.seconds_of("front.samples"))
