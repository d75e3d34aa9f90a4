"""Seconds of the program's ``front.analysis`` span (``PlotAnalyzer``'s
spectra and chroma of the input and the output, on an executor's worker),
the median over the window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("front.analysis",), program.seconds_of("front.analysis"))
