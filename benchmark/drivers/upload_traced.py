"""The ``upload`` traffic on a backend whose operator runs it with the
program's tracer on (``AEFS_TRACE=1``, as one who reads ``get_stats``
does): the tracer enabled and reset, then ``drivers/upload.py``'s ``run``
unchanged, then the tracer's export in ``obs["program"]`` with the rids
of the window's uploads (``warmup_uploads`` on, one a reply; the traced
upload after the window is the next), and the tracer off and reset.

While ``run`` runs, ``tracing.summarize`` is handed a view of the
profiler's trace whose events are its own plus one host event per
program span, moved onto the profiler's clock by the export's
``trace_offset_ns``: the traced upload's idle gaps are then named by the
innermost span open at their middle on any thread, the executor's
workers included, where the profiler keeps the ranges of its own thread
alone.  A program without the offset gets the profiler's events alone.
"""

from __future__ import annotations

import json
import time

from .. import program, tracing
from . import upload

# Spans the profiler also holds as ranges of its own, opened on the loop's
# thread, which runs the traced upload under the profiler.  (``front.upload``
# starts at a clock read made before its range opens.)
MIRRORED = ("front.decode", "front.send")


class _SpanEvent:
    """A program span as ``summarize`` reads a host event."""

    __slots__ = ("_name", "_start", "_ns")

    def __init__(self, name, start, ns):
        self._name, self._start, self._ns = name, start, ns

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._ns

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CPU


class _View:
    """``prof`` as ``summarize`` reads it:
    ``prof.profiler.kineto_results.events()``."""

    def __init__(self, events):
        self.profiler = self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _span_events(export):
    off = export.get("clock", {}).get("trace_offset_ns")
    if off is None:
        return []
    return [_SpanEvent(name, s + off, e - s)
            for name, spans in export["spans"].items() for _r, s, e in spans]


def _mirror_gap_us(events, export, rid):
    """The largest distance (us) from a span of upload ``rid`` opened on
    the profiling thread, moved by the offset, to the start of its own
    range in the trace; None without a pair."""
    off = export.get("clock", {}).get("trace_offset_ns")
    if off is None:
        return None
    gaps = []
    for name in MIRRORED:
        mine = [s + off for r, s, _e in export["spans"].get(name, ()) if r == rid]
        theirs = [ev.start_ns() for ev in events if ev.name() == name]
        gaps += [min(abs(t - m) for t in theirs) / 1e3 for m in mine if theirs]
    return max(gaps) if gaps else None


def run(ctx):
    from aefs_tpu_torch.utils.metrics import TRACER

    warm = ctx.cell.traffic["warmup_uploads"]
    original = tracing.summarize
    seen = {}

    def summarize(prof):
        ex = TRACER.export()
        events = list(prof.profiler.kineto_results.events())
        seen["mirror_gap_us"] = _mirror_gap_us(events, ex, max(
            (r for r, _s, _e in ex["spans"].get("front.upload", ())), default=None))
        return original(_View(events + _span_events(ex)))

    TRACER.enable()
    TRACER.reset()
    tracing.summarize = summarize
    try:
        oc = upload.run(ctx)
        export = TRACER.export()
    finally:
        tracing.summarize = original
        TRACER.disable()
        TRACER.reset()
    oc.obs["program"] = {**export, "uploads": list(range(warm, warm + oc.attempted))}
    # Each span's median seconds per upload over the window's uploads, and
    # front_s.upload's twin from them: front.upload less engine.render.
    names = sorted({"front.upload", "engine.render", "chain.file_effect",
                    *(n for n in export["spans"] if n.startswith(("front.", "engine.")))})
    oc.notes["spans_s"] = {n: program.median(oc.obs, (n,), program.seconds_of(n))
                           for n in names}
    oc.notes["front_less_render_s"] = program.median(
        oc.obs, ("front.upload", "engine.render"),
        program.self_seconds("front.upload", ("engine.render",)))
    # What front_s.upload holds and front.upload cannot: the client's own
    # JSON encode of an upload message before the handler takes it, timed
    # on a message of the same length.
    frames = oc.obs["shapes"]["frames"]
    msg = {"command": "process_file",
           "contents": "data:audio/wav;base64," + "A" * (4 * ((44 + 4 * frames + 2) // 3))}
    t0 = time.perf_counter()
    json.dumps(msg)
    oc.notes["client_encode_s"] = time.perf_counter() - t0
    if ctx.trace:
        oc.notes["mirror_gap_us"] = seen.get("mirror_gap_us")
    return oc
