"""Seconds of the program's ``front.upload`` span (the handler taking the
message to ``send`` returning) that none of its children covers:
``front.decode``, ``front.hop`` (the executor's hops), ``engine.render``,
``front.analysis``, ``front.serialize``, ``front.send``.  What is left is
the loop's own time: the message's parse, the task's start, the waits
between the parts.  The median per upload over the window's uploads."""

LAYER = "front (server/backend.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "upload_x_realtime"

from benchmark import program

CHILDREN = ("front.decode", "front.hop", "engine.render", "front.analysis",
            "front.serialize", "front.send")


def read(obs):
    return program.median(obs, ("front.upload",) + CHILDREN,
                          program.self_seconds("front.upload", CHILDREN))
