"""What the stream cells share: their seeded mono input, and the timing
of blocks against the audio clock.

Live audio does not queue: a client hands over only the newest block that
is due, skipping older ones, whenever its previous call or reply is still
out.  A block's latency runs from its due time to when the client holds
its processed output; a skipped block's, to when it holds the output of
the first block handed over after it, so skipping never lowers the tail.
"""

from __future__ import annotations

import bisect

import numpy as np

from .audio import rain_scene, seed_of


def session_inputs(seed: int, sessions: int, samples: int, fs: int, which=None,
                   hop_s: float = 0.37):
    """{session: (samples,) float32 mono} for the sessions in ``which``
    (all by default): excerpts of one seeded rain scene, each at its own
    offset, from alternating sides (L, R, mix) and with alternating
    polarity, so that no two sessions' audio is the same."""
    hop = int(hop_s * fs)
    base = rain_scene((samples + hop * sessions) / fs + 0.01, fs, seed_of(seed, 17))
    out = {}
    for s in range(sessions) if which is None else which:
        seg = base[s * hop: s * hop + samples]
        mono = (seg[:, 0], seg[:, 1], seg.mean(axis=1))[s % 3]
        out[s] = mono if (s // 3) % 2 == 0 else -mono
    return out


def latencies(handed, reply_t, origin: float, period: float, k_lo: int, k_hi: int):
    """Latency (s) and skipped flag of every block k in [k_lo, k_hi).

    ``handed`` are the block indices handed over, in order, and
    ``reply_t[i]`` when the client held handed[i]'s output (None if
    never).  A block with no later reply has an infinite latency."""
    handed = list(handed)
    lat = np.full(k_hi - k_lo, np.inf)
    skipped = np.zeros(k_hi - k_lo, bool)
    for k in range(k_lo, k_hi):
        i = bisect.bisect_left(handed, k)
        if i == len(handed):
            skipped[k - k_lo] = True
            continue
        skipped[k - k_lo] = handed[i] != k
        if reply_t[i] is not None:
            lat[k - k_lo] = reply_t[i] - (origin + k * period)
    return lat, skipped


def err_dbfs(peak_abs_err: float) -> float:
    return -np.inf if peak_abs_err == 0 else 20.0 * float(np.log10(peak_abs_err))
