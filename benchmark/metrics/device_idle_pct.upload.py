"""Share of the traced upload (from its first to its last device record)
in which no operation ran on the card: 1 - union of device intervals /
traced time."""

LAYER = "device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"

def read(obs):
    tr = obs.get("trace")
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
