"""The yardstick of a kernel's roofline share: the published peaks of one
NVIDIA H100 SXM and, for each hand-written kernel, the bytes and float32
operations its work needs, counted from the shapes it is called at
(whatever implements it).  The counts are those of PERF.md's kernel
table (K1 19.5 KB at one slot, K2 14.4 MB for one demo-length file)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # device memory bandwidth
F32_FLOPS = 67e12  # float32 outside the tensor cores

# K1, the octaver's block step: float32 operations per output sample at
# two channels (phase ramp 75, two distances 2, two Hermite reads 40, two
# Hann gains 8, wet 3, mono 2, blend 6) and once per slot and call for the
# prologue (the ratio in double-single, the step, its levels, the fold).
OCTAVER_STEP_OPS, OCTAVER_PROLOGUE_OPS = 136, 700
# K2, the reverb's comb bank: per comb and sample the recursion
# (y = x + g r, then damped = h d + (1 - h) y) and one add into its side.
COMB_OPS = 5


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def k1_work(slots: int, block: int, ring: int):
    """(bytes, flops) of one K1 launch over ``slots`` slots: it reads each
    slot's block (2 x block), ring and 8 scalars, and writes its output,
    ring and 6 scalars."""
    n_bytes = slots * (4 * (2 * block + ring + 8) + 4 * (2 * block + ring + 6))
    return n_bytes, slots * (OCTAVER_STEP_OPS * block + OCTAVER_PROLOGUE_OPS)


def comb_chunk(lags) -> int:
    """The chunk C of the comb solve: the largest multiple of 128 with
    C <= L < 2C for every lag, else the shortest lag."""
    c = (min(lags) // 128) * 128
    if not c or not all(c <= lag < 2 * c for lag in lags):
        c = min(lags)
    return c


def k2_work(frames: int, lags, files: int = 1, sides: int = 2):
    """(bytes, flops) of one K2 call (the comb sums of a whole file): it
    reads the signal (sides x frames per file), the gains and the damping,
    and writes each side's sum over the chunks and three tail values per
    comb and lane."""
    b, c = len(lags), comb_chunk(lags)
    m = -(-frames // c)
    n_bytes = 4 * (files * sides * frames + b + 1) + 4 * files * (sides * m * c + 3 * b * c)
    return n_bytes, files * b * m * c * (COMB_OPS + 1)


def reverb_lags(fs: int, comb_times_ms=(29.7, 37.1, 41.1, 43.7), jitter_ms=0.3,
                max_delay_ms=200.0):
    """Both sides' comb lags, as the reverb derives them."""
    return [max(1, int(fs * min(t + j, max_delay_ms - 1.0) / 1000.0))
            for j in (jitter_ms, -jitter_ms) for t in comb_times_ms]
