"""K2's share of its roofline in the traced upload: the least time its
bytes and float32 operations need at the card's published peaks (counted
from the file's shape by benchmark/roofline.py), over the device time of
its kernels (comb_bank_kernel and comb_side_sums_kernel) per render."""

LAYER = "kernels (csrc via ops/kernels)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"

from benchmark import roofline, tracing


def read(obs):
    tr, sh = obs.get("trace"), obs["shapes"]
    if tr is None or sh.get("reverb") is None:
        return None
    sec, n = tracing.kernel_time(tr, ("comb_bank_kernel", "comb_side_sums_kernel"))
    if not n:
        return None
    frames = -(-sh["frames"] // sh["superblock"]) * sh["superblock"]
    p = sh["reverb"]
    lags = roofline.reverb_lags(sh["fs"], jitter_ms=p.get("jitter_ms", 0.3))
    # one render per traced upload, K2 once per render
    return 100.0 * roofline.bound_s(*roofline.k2_work(frames, lags)) / sec
