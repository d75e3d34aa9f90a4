"""Device kernels in the traced upload, Memcpy and Memset records left out
(fills are kernels and counted): the sum of the trace's launches by
kernel name, the front's included.  Nearly all of them are the auto-wah's
whole-file pass as eager PyTorch ops: the LFO ramp, the envelope's
one-pole scan, the sweep and f, then the 2x2 state-variable scan's
ceil(log2 N) levels over six (2, N) coefficient arrays (``ops/scan.py:
mat2_affine_hillis``), and the slap delay after it.  It is the count that
a fused solve of the wah must bring down."""

LAYER = "effects (models/wah.py, ops/scan.py:mat2_affine_hillis)"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"


def read(obs):
    tr = obs.get("trace")
    if tr is None or not tr["kernel_n"]:
        return None
    return sum(tr["kernel_n"].values())
