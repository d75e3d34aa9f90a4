"""K1's share of its roofline inside the step's replay: the least time its
bytes and float32 operations need at the card's published peaks, from the
(slots, 2, block) shape (benchmark/roofline.py), over the mean device
time of an octaver_step_kernel launch in the trace."""

LAYER = "kernels (csrc via ops/kernels)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "block_p99_ms"

from benchmark import roofline, tracing

RING_MS = 40.0  # the octaver's grain window


def read(obs):
    tr, sh = obs.get("trace"), obs["shapes"]
    if tr is None:
        return None
    sec, n = tracing.kernel_time(tr, ("octaver_step_kernel",))
    if not n:
        return None
    ring = max(int(sh["fs"] * RING_MS / 1000.0), 16)
    return 100.0 * roofline.bound_s(*roofline.k1_work(sh["slots"], sh["block"], ring)) / (sec / n)
