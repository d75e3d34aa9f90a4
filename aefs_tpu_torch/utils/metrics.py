"""Observability: per-block timing, deadline tracking, profiler traces
(port of aefs_tpu/utils/metrics.py).

- ``BlockTimer``: rolling window of per-block wall times with p50/p99,
  realtime factor and a deadline-miss (xrun) counter measured against the
  audio deadline (blocksize / fs).
- ``trace()``: context manager around ``torch.profiler`` that writes a
  Chrome trace of the host and (with a card) the device under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np


class BlockTimer:
    """Rolling window of per-block processing times."""

    def __init__(self, fs: int, blocksize: int, window: int = 2048):
        self.fs = fs
        self.blocksize = blocksize
        self.deadline_s = blocksize / float(fs)
        self._times = np.zeros(window, np.float64)
        self._n = 0
        self._idx = 0
        self._xruns = 0
        self._total_blocks = 0
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def block(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # A block that raises still consumed wall time; skipping it
            # would understate the p99 and xruns this timer exists to show.
            self.record(time.perf_counter() - t0)

    def record(self, seconds: float):
        with self._lock:
            self._times[self._idx] = seconds
            self._idx = (self._idx + 1) % len(self._times)
            self._n = min(self._n + 1, len(self._times))
            self._total_blocks += 1
            if seconds > self.deadline_s:
                self._xruns += 1

    def snapshot(self) -> dict:
        with self._lock:
            n = self._n
            times = self._times[:n].copy()
            xruns = self._xruns
            total = self._total_blocks
        if n == 0:
            return {"blocks": 0, "xruns": xruns}
        p50, p99 = np.percentile(times, [50, 99])
        return {
            "blocks": int(total),
            "xruns": int(xruns),
            "deadline_ms": round(self.deadline_s * 1000, 3),
            "p50_ms": round(float(p50) * 1000, 3),
            "p99_ms": round(float(p99) * 1000, 3),
            "max_ms": round(float(times.max()) * 1000, 3),
            "realtime_factor": round(self.deadline_s / max(float(np.mean(times)), 1e-9), 1),
        }


@contextlib.contextmanager
def trace(log_dir: str = "aefs_trace"):
    """Capture a ``torch.profiler`` trace around a region of interest and
    write it to ``log_dir/trace.json`` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
