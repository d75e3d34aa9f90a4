"""Reading a ``torch.profiler`` trace: the device's busy time (the union
of its intervals), kernels per CUDA graph replay (kernels whose CUPTI
correlation id is that of a ``cudaGraphLaunch``; the most any replay
holds, because the profiler drops device records), each kernel's time,
and the breakdown the result line carries (the device operations that
took most time, and the longest idle gaps by what the host was doing).
The union arithmetic is a copy of ``scripts/profile_port.py:_union_ms``."""

from __future__ import annotations

from collections import defaultdict


def union(intervals):
    """[(start, end)] -> the merged intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


START, END = "bench:traced_start", "bench:traced_end"


def mark(name):
    """An instant on the profiler's host timeline (START or END): the traced
    window runs from the first START to the last END."""
    from torch.profiler import record_function

    with record_function(name):
        pass


def summarize(prof):
    """The trace's numbers, in seconds, over the window between the marks
    (from the first to the last device record where there are none)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, launches, marks = [], [], [], {START: [], END: []}
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            dev.append((s, e, ev.name(), ev.correlation_id()))
        else:
            host.append((s, e, ev.name()))
            if ev.name() in marks:
                marks[ev.name()].append(s)
            if ev.name().startswith("cudaGraphLaunch"):
                launches.append(ev.correlation_id())
    if not dev:
        return None
    lo = min(marks[START]) if marks[START] else min(s for s, *_ in dev)
    hi = max(marks[END]) if marks[END] else max(e for _, e, *_ in dev)
    busy = union([(max(s, lo), min(e, hi)) for s, e, *_ in dev if e > lo and s < hi])
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    per_launch = defaultdict(int)
    for s, e, name, corr in dev:
        if name.startswith(("Memcpy", "Memset")):
            continue
        kernel_s[name] += (e - s) / 1e9
        kernel_n[name] += 1
        per_launch[corr] += 1
    replays = [per_launch.get(c, 0) for c in launches]
    # Idle gaps between merged busy intervals; the 500 longest are named
    # by the innermost host event open at the gap's middle.
    edges = [(lo, lo)] + [tuple(iv) for iv in busy] + [(hi, hi)]
    spans = sorted(((b - a, a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a),
                   reverse=True)[:500]
    gaps = defaultdict(float)
    for length, a, b in spans:
        mid = (a + b) / 2
        inner = [(e - s, name) for s, e, name in host if s <= mid <= e]
        gaps[min(inner)[1] if inner else "no host event"] += length / 1e9
    by_time = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": dict(kernel_s),
        "kernel_n": dict(kernel_n),
        "replay_kernels": replays,
        "breakdown": {
            "device_ops": [[name, sec] for name, sec in by_time[:10]],
            "idle_gaps": [[name, sec] for name, sec in sorted(gaps.items(),
                                                              key=lambda kv: -kv[1])[:10]],
        },
    }


def kernel_time(summary, names):
    """(seconds, launches) of the kernels whose names contain one of ``names``."""
    sec = sum(v for k, v in summary["kernel_s"].items() if any(n in k for n in names))
    cnt = sum(v for k, v in summary["kernel_n"].items() if any(n in k for n in names))
    return sec, cnt
