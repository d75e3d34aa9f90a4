"""Observability: per-block timing, deadline tracking, and the program's
spans and counters (port of aefs_tpu/utils/metrics.py).

- ``BlockTimer``: rolling window of per-block wall times with p50/p99,
  realtime factor and a deadline-miss (xrun) counter measured against the
  audio deadline (blocksize / fs).
- ``TRACER``: the program's one tracer.  ``TRACER.span(name, rid)`` times
  a stretch of work belonging to request ``rid`` (an upload, a block, a
  pool step), ``TRACER.count(name, n)`` adds to a counter.  Spans are kept
  in memory, in one bounded ring per name, on ``time.perf_counter_ns``;
  nothing is written to disk.  While a ``torch.profiler`` session runs, an
  enabled tracer's span also opens a host range of its name, so it lies on
  the profiler's host timeline beside the device's records.  The profiler
  keeps the ranges of the thread that started it alone; ``export()``
  carries the offset from the rings' clock to the profiler's (unix
  nanoseconds), so a span of any thread can be put on that timeline.
- ``TRACER.hop(name, rid, fn)``: ``fn`` for ``run_in_executor``, its wait
  for a worker thread kept as span ``name``; ``TRACER.landed(call)``
  after the ``await`` keeps the way back, from ``fn``'s return to the
  coroutine running again.

The tracer records only while it is enabled (``TRACER.enable()``, or
``AEFS_TRACE=1`` in the environment at import); a profiler session alone
does not turn it on.  Disabled, ``span`` returns one shared no-op span (no
clock read, no allocation), ``hop`` returns ``fn`` itself, and ``count``
and ``landed`` return at once.
``get_stats`` (server/backend.py) and ``get_pool_stats`` (server/pool.py)
carry ``TRACER.snapshot()`` under ``"trace"`` while it is enabled.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import numpy as np
import torch.autograd.profiler as _autograd_profiler
# An op-like host range (a ``cpu_op`` event).  ``record_function`` makes a
# user annotation, which the profiler mirrors on the device timeline over
# the kernels it encloses: a span around a graph replay would then add a
# device record to each replay and count the gaps between its kernels as
# busy.
from torch._C._profiler import _RecordFunctionFast

# Entries per span name: a 30 s window of 256-sample blocks at 48 kHz is
# 5,625 blocks.
RING = 16384


def trace_offset_ns() -> int:
    """``time.time_ns()`` (the profiler's clock) less ``perf_counter_ns()``
    (the rings'), from the tightest of five reads of the one between two
    of the other."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


class _NoSpan:
    """The span of a disabled tracer: enters, exits and closes as
    nothing."""

    __slots__ = ()
    rid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


NO_SPAN = _NoSpan()


class Span:
    """One open span: started at construction (or at ``t0``, a
    ``perf_counter_ns`` read already made), ended by ``close`` or by
    leaving its ``with`` block.  ``ns`` is its duration once closed.  It
    is kept in its tracer's ring when ``keep`` is set."""

    __slots__ = ("tracer", "name", "rid", "keep", "t0", "ns", "_range")

    def __init__(self, tracer, name, rid, keep, t0=None):
        self.tracer, self.name, self.rid, self.keep = tracer, name, rid, keep
        self.ns = None
        self._range = None
        if keep and _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns() if t0 is None else t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self.t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.keep:
            self.tracer.record(self.name, self.rid, self.t0, t1)


class _Hop:
    """``fn`` run on an executor's worker: the wait from the submit to the
    worker's start is kept as span ``name`` of ``rid`` when it starts;
    ``t1`` is when ``fn`` returned, the start of the way back."""

    __slots__ = ("tracer", "name", "rid", "fn", "t0", "t1")

    def __init__(self, tracer, name, rid, fn):
        self.tracer, self.name, self.rid, self.fn = tracer, name, rid, fn
        self.t1 = None
        self.t0 = time.perf_counter_ns()

    def __call__(self, *args):
        self.tracer.record(self.name, self.rid, self.t0, time.perf_counter_ns())
        try:
            return self.fn(*args)
        finally:
            self.t1 = time.perf_counter_ns()


class Tracer:
    """Spans in one ring per name, each entry ``(rid, start_ns,
    duration_ns)``; counters by name.  ``dropped`` counts the entries a
    ring let go when it wrapped.  ``offset_ns`` is ``trace_offset_ns()``
    as ``reset`` or ``enable`` last read it."""

    def __init__(self, capacity: int = RING, enabled: bool = False):
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self.reset()

    def enable(self):
        self.offset_ns = trace_offset_ns()
        self.enabled = True

    def disable(self):
        self.enabled = False

    def span(self, name: str, rid=None, t0=None):
        """An open span of request ``rid`` (a context manager; ``close``
        ends it too), or ``NO_SPAN`` while the tracer is disabled."""
        if not self.enabled:
            return NO_SPAN
        return Span(self, name, rid, True, t0)

    def timed(self, name: str, rid=None):
        """A span that reads the clock even while the tracer is disabled,
        for an owner that keeps its own number from the same two reads
        (``BlockTimer``, the pool's ``last_step_ms``, a runner's
        ``capture_s``); it is kept only while the tracer is enabled."""
        return Span(self, name, rid, self.enabled)

    def hop(self, name: str, rid, fn):
        """``fn`` for ``run_in_executor``, its wait for a worker kept as span
        ``name`` of ``rid``; ``fn`` itself while the tracer is disabled."""
        if not self.enabled:
            return fn
        return _Hop(self, name, rid, fn)

    def landed(self, call):
        """After awaiting ``hop``'s ``call``: keeps the way back, from its
        ``fn``'s return to now, as a second span of its name and rid."""
        if type(call) is _Hop and call.t1 is not None:
            self.record(call.name, call.rid, call.t1, time.perf_counter_ns())

    def clock(self):
        """``perf_counter_ns()`` while enabled, else None: the start of a
        span that ``record`` closes elsewhere."""
        if not self.enabled:
            return None
        return time.perf_counter_ns()

    def record(self, name: str, rid, t0, t1):
        """Keep a span read elsewhere; nothing when ``t0`` or ``t1`` is
        None (read while the tracer was disabled)."""
        if t0 is None or t1 is None:
            return
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = self._rings[name] = deque(maxlen=self.capacity)
                self._totals[name] = 0
            ring.append((rid, t0, t1 - t0))
            self._totals[name] += 1

    def count(self, name: str, n: int = 1):
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def reset(self):
        with self._lock:
            self._rings, self._totals, self._counters = {}, {}, {}
            self.offset_ns = trace_offset_ns()

    def export(self) -> dict:
        """``{"spans": {name: [[rid, start_ns, end_ns], ...]}, "counters":
        {name: n}, "dropped": {name: n}, "clock": {"trace_offset_ns": n}}``:
        enough to compute a layer's self time (its span less the parts its
        child spans cover); ``start_ns + n`` is a span's start on the
        profiler's timeline, from any thread."""
        with self._lock:
            spans = {name: [[rid, t0, t0 + ns] for rid, t0, ns in ring]
                     for name, ring in self._rings.items()}
            dropped = {name: self._totals[name] - len(ring)
                       for name, ring in self._rings.items()}
            counters = dict(self._counters)
        return {"spans": spans, "counters": counters, "dropped": dropped,
                "clock": {"trace_offset_ns": self.offset_ns}}

    def snapshot(self) -> dict:
        """Each span's count, p50 and p99 in ms over its ring, the
        counters and the drops."""
        with self._lock:
            rings = {name: np.array([ns for _r, _t, ns in ring], np.float64)
                     for name, ring in self._rings.items()}
            totals = dict(self._totals)
            counters = dict(self._counters)
        spans = {}
        for name, ns in rings.items():
            p50, p99 = np.percentile(ns, [50, 99]) / 1e6
            spans[name] = {"count": totals[name], "p50_ms": round(float(p50), 4),
                           "p99_ms": round(float(p99), 4)}
        return {"spans": spans, "counters": counters,
                "dropped": {name: totals[name] - len(ns) for name, ns in rings.items()}}


TRACER = Tracer(enabled=os.environ.get("AEFS_TRACE", "0") == "1")


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
    def block(self, rid=None):
        """Time one block; the tracer's ``engine.block`` span of request
        ``rid`` is the same two clock reads."""
        span = TRACER.timed("engine.block", rid)
        try:
            yield
        finally:
            span.close()
            # A block that raises still consumed wall time; skipping it
            # would understate the p99 and xruns this timer exists to show.
            self.record(span.ns / 1e9)

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
