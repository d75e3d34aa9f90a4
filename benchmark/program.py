"""The program's own spans as a traced cell's readers take them.

``obs["program"]`` is ``TRACER.export()`` of the run (``utils/metrics.py``
in the port: ``spans`` as ``{name: [[rid, start_ns, end_ns], ...]}``,
``counters``, ``dropped``, and ``clock``, the offset onto the profiler's
timeline) with ``uploads``, the rids of the window's uploads.  The front's
spans and ``engine.render`` carry their upload's rid; every other span
(``chain.file_effect``, the effects' own) belongs to the upload whose
``front.upload`` holds it.  Every function returns None where the run has
no such span, or where a ring it reads let entries go (``dropped``).
"""

from __future__ import annotations

import statistics

UPLOAD = "front.upload"


def _carries_rid(name: str) -> bool:
    return name.startswith("front.") or name == "engine.render"


def per_upload(obs, names):
    """``{rid: {name: [(start_ns, end_ns), ...]}}`` of the window's uploads,
    or None (no export, or a ring of ``names`` or of ``front.upload``
    that dropped entries)."""
    prog = obs.get("program")
    if not prog:
        return None
    dropped = prog.get("dropped", {})
    if any(dropped.get(n, 0) for n in (UPLOAD, *names)):
        return None
    spans = prog["spans"]
    rids = set(prog["uploads"])
    out = {r: {n: [] for n in names} for r in rids}
    bounds = sorted((s, e, r) for r, s, e in spans.get(UPLOAD, ()) if r in rids)
    for name in names:
        for rid, s, e in spans.get(name, ()):
            if _carries_rid(name):
                if rid in out:
                    out[rid][name].append((s, e))
            else:
                owner = next((r for u0, u1, r in bounds if u0 <= s and e <= u1), None)
                if owner is not None:
                    out[owner][name].append((s, e))
    return out


def union_ns(intervals, lo=None, hi=None) -> int:
    """Nanoseconds covered by ``intervals``, each clipped to [lo, hi]."""
    total, end = 0, None
    for s, e in sorted(intervals):
        s = s if lo is None else max(s, lo)
        e = e if hi is None else min(e, hi)
        if e <= s:
            continue
        if end is not None and s < end:
            if e > end:
                total += e - end
                end = e
        else:
            total += e - s
            end = e
    return total


def median(obs, names, value):
    """The median over the window's uploads of ``value(spans)``, where
    ``spans`` is the upload's ``{name: [(start_ns, end_ns), ...]}``;
    uploads for which ``value`` gives None are left out."""
    ups = per_upload(obs, names)
    if ups is None:
        return None
    vals = [v for v in (value(d) for d in ups.values()) if v is not None]
    return statistics.median(vals) if vals else None


def seconds_of(*names):
    """``value`` for ``median``: the seconds the upload spent in ``names``
    (their durations summed), or None where one of them is missing."""
    def value(d):
        if not all(d[n] for n in names):
            return None
        return sum(e - s for n in names for s, e in d[n]) / 1e9
    return value


def self_seconds(parent, children):
    """``value`` for ``median``: the seconds of the upload's one ``parent``
    span that none of ``children`` covers."""
    def value(d):
        if len(d[parent]) != 1:
            return None
        (p0, p1), = d[parent]
        kids = [iv for n in children for iv in d[n]]
        return (p1 - p0 - union_ns(kids, p0, p1)) / 1e9
    return value
