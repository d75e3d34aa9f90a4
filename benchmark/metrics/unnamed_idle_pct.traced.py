"""Share of the traced upload's idle card time that no host event names:
100 x the idle gaps whose middle no host event, the program's spans
included (``drivers/upload_traced.py``), lies in ("no host event" in the
breakdown's ``idle_gaps``, which names the 500 longest gaps) over
``window_s - busy_s``.  None where the program's spans could not be put on
the profiler's clock (no ``trace_offset_ns`` in its export)."""

LAYER = "device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"


def read(obs):
    tr, prog = obs.get("trace"), obs.get("program") or {}
    if tr is None or "trace_offset_ns" not in prog.get("clock", {}):
        return None
    idle = tr["window_s"] - tr["busy_s"]
    unnamed = dict(tr["breakdown"]["idle_gaps"]).get("no host event", 0.0)
    return 100.0 * unnamed / idle if idle > 0 else None
