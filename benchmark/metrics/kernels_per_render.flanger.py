"""Device kernels in the traced upload, Memcpy and Memset records left out
(fills are kernels and counted): the sum of the trace's launches by
kernel name, the front's included.  Nearly all of them are the flanger's
whole-file solve (its one-hot builds, squarings and the chunk chain's
gathers and matvecs); the count a fused solve must bring down."""

LAYER = "effects (models/flanger.py, ops/scan.py:_matmul)"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"


def read(obs):
    tr = obs.get("trace")
    if tr is None or not tr["kernel_n"]:
        return None
    return sum(tr["kernel_n"].values())
