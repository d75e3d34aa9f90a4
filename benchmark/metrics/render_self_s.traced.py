"""Seconds of the program's ``engine.render`` span (the fresh chain's
whole-file render, on an executor's worker) that no ``chain.file_effect``
span inside it covers: the chain's build, the staging of the file onto
the card, the readback and the clip.  The median per upload over the
window's uploads."""

LAYER = "engine (engine/engine.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program


def read(obs):
    return program.median(obs, ("engine.render", "chain.file_effect"),
                          program.self_seconds("engine.render", ("chain.file_effect",)))
