"""Milliseconds of the upload's four ``front.hop`` spans summed: for each
of its two ``run_in_executor`` calls (the render; the analysis and the
serialize), the submit to the worker's start and the worker's return to
the coroutine running again.  More than ~2 ms means the executor or the
GIL queues the upload.  The median per upload over the window's
uploads."""

LAYER = "front (server/backend.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    s = program.median(obs, ("front.hop",), program.seconds_of("front.hop"))
    return None if s is None else 1000.0 * s
