"""What the program's tracer (``aefs_tpu_torch/utils/metrics.py:TRACER``)
costs and what it shows with the profiler off, on the card:

    python3 benchmark/trace_cost.py --seconds 10 --out build/trace_cost.json

- ``span_ns``: nanoseconds per span, off, enabled, and under a
  ``torch.profiler`` session (which adds a host range).
- ``live``: for each chain of the live cells, one engine driven on the
  audio clock as ``drivers/live.py`` drives it (newest due block only),
  in windows of ``--seconds`` with the tracer off and on in turns (off,
  on, on, off): each window's call (service) p50/p99 and block p99, and,
  with the tracer on, the percentiles and a histogram of each span
  (``chain.replay``, ``engine.collect``, ...) and the counters, the
  tracer reset at the window's start.
- ``upload``: ``flagship.upload`` through the harness with the tracer on
  and no profiler: each front span's median, ``front.upload``'s median
  and the share its children leave.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HIST_MS = [0, 0.25, 0.5, 1, 2, 3, 4, 5, 6, 7, 7.5, 8, 8.5, 9, 10, 12, 16, 1e9]


def span_cost(tracer, n):
    """ns per ``with tracer.span(...)`` over ``n`` spans."""
    t0 = time.perf_counter_ns()
    for i in range(n):
        with tracer.span("cost.span", i):
            pass
    return (time.perf_counter_ns() - t0) / n


def span_ns(device):
    from torch.profiler import ProfilerActivity, profile

    from aefs_tpu_torch.utils.metrics import Tracer

    off, on = Tracer(), Tracer(enabled=True)
    out = {"off": span_cost(off, 200000), "enabled": span_cost(on, 100000)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts):  # an enabled span then opens a host range too
        out["profiled"] = span_cost(on, 20000)
    return out


def _pcts(values_ms):
    v = np.asarray(values_ms, np.float64)
    return {f"p{q}": float(np.percentile(v, q)) for q in (1, 10, 50, 90, 99)} | {
        "n": int(v.size), "hist": np.histogram(v, HIST_MS)[0].tolist()}


def live(cell, seconds, device, seed):
    """Windows of one engine on the audio clock, tracer off and on in turns."""
    import torch

    from aefs_tpu_torch.engine.engine import AudioEngine
    from aefs_tpu_torch.utils.metrics import TRACER

    from benchmark import harness
    from benchmark.drivers.live import _drive
    from benchmark.streams import session_inputs

    c = harness.find_cell(cell)
    cfg, tr = c.config, c.traffic
    fs, block = cfg["sample_rate"], cfg["blocksize"]
    period = block / fs
    order = ["off", "on", "on", "off"]
    per = int(seconds / period)
    n_blocks = tr["warmup_blocks"] + per * len(order) + tr["slack_blocks"]
    mono = session_inputs(seed, 1, n_blocks * block, fs)[0]
    blocks = mono.reshape(n_blocks, block, 1)
    eng = AudioEngine(device=device)
    eng.build_chain(cfg["chain"])
    calls = []

    def record(k, t_call, t_ret, out):
        calls.append((k, t_call, t_ret))

    gc.collect()
    gc.disable()
    origin = time.perf_counter()
    k = _drive(eng.process_stream_block_pipelined, blocks, origin, period, 0,
               lambda kk: kk >= tr["warmup_blocks"] - 1, record)
    windows = []
    for i, mode in enumerate(order):
        k_end = tr["warmup_blocks"] + per * (i + 1)
        TRACER.reset()
        (TRACER.enable if mode == "on" else TRACER.disable)()
        n0 = len(calls)
        k = _drive(eng.process_stream_block_pipelined, blocks, origin, period, k,
                   lambda kk: kk >= k_end - 1, record)
        TRACER.disable()
        mine = calls[n0:]
        service = [1000.0 * (t1 - t0) for _k, t0, t1 in mine]
        # A block's output comes back with the next call: the latency from
        # its due time to that call's return.
        lat = [1000.0 * (b[2] - (origin + a[0] * period)) for a, b in zip(mine, mine[1:])]
        w = {"mode": mode, "calls": len(mine), "service_ms": _pcts(service),
             "block_p99_ms": float(np.percentile(lat, 99)),
             "served_x_realtime": len(mine) * period / (mine[-1][2] - mine[0][1])}
        if mode == "on":
            ex = TRACER.export()
            w["spans_ms"] = {name: _pcts([(e - s) / 1e6 for _r, s, e in sp])
                             for name, sp in ex["spans"].items()}
            w["counters"] = ex["counters"]
            w["dropped"] = ex["dropped"]
            # Per call: the graph launch and the readback wait side by side.
            rep = {r: (e - s) / 1e6 for r, s, e in ex["spans"].get("chain.replay", ())}
            col = {r: (e - s) / 1e6 for r, s, e in ex["spans"].get("engine.collect", ())}
            blk = {r: (e - s) / 1e6 for r, s, e in ex["spans"].get("engine.block", ())}
            both = [(blk[r], rep[r], col[r]) for r in blk if r in rep and r in col]
            if both:
                b = np.asarray(both)
                slow = b[:, 0] > np.median(b[:, 0])
                w["split_by_call"] = {
                    "calls_above_median": {"block": float(b[slow, 0].mean()),
                                           "replay": float(b[slow, 1].mean()),
                                           "collect": float(b[slow, 2].mean())},
                    "calls_at_or_below": {"block": float(b[~slow, 0].mean()),
                                          "replay": float(b[~slow, 1].mean()),
                                          "collect": float(b[~slow, 2].mean())},
                    "corr_block_replay": float(np.corrcoef(b[:, 0], b[:, 1])[0, 1]),
                    "corr_block_collect": float(np.corrcoef(b[:, 0], b[:, 2])[0, 1])}
        windows.append(w)
    gc.enable()
    eng.close()
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return windows


def upload(seconds, device, seed):
    from aefs_tpu_torch.utils.metrics import TRACER

    from benchmark import harness

    TRACER.reset()
    TRACER.enable()
    try:
        line = harness.run("flagship.upload", seed, seconds, False, time.perf_counter(),
                           device=device)
        ex = TRACER.export()
    finally:
        TRACER.disable()
    sp = ex["spans"]
    warm = harness.find_cell("flagship.upload").traffic["warmup_uploads"]
    keep = {r for r, _s, _e in sp["front.upload"] if r >= warm}

    def med(name):
        v = [(e - s) / 1e9 for r, s, e in sp.get(name, ()) if r in keep]
        return statistics.median(v) if v else None

    children = ("front.decode", "engine.render", "front.analysis", "front.serialize",
                "front.send")
    left = []
    for r, s, e in sp["front.upload"]:
        if r in keep:
            kids = sum(ce - cs for n in children for cr, cs, ce in sp.get(n, ()) if cr == r)
            left.append((e - s - kids) / 1e9)
    return {"upload_x_realtime": line["metrics"]["upload_x_realtime"]["value"],
            "uploads": len(keep), "median_s": {n: med(n) for n in ("front.upload",) + children},
            "self_s_median": statistics.median(left) if left else None,
            "counters": ex["counters"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 4242)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", nargs="*",
                    default=["flagship.live", "multiband_master.live", "flagship.upload"])
    ap.add_argument("--out", default="build/trace_cost.json")
    args = ap.parse_args()

    from benchmark import harness

    harness.cache_env(harness.ROOT)
    report = {"card": harness.card_facts() if args.device == "cuda" else "cpu",
              "span_ns": span_ns(args.device)}
    print(json.dumps({"span_ns": report["span_ns"]}), flush=True)
    for cell in args.cells:
        if cell == "flagship.upload":
            report[cell] = upload(args.seconds, args.device, args.seed)
        else:
            report[cell] = live(cell, args.seconds, args.device, args.seed)
        print(json.dumps({cell: report[cell]})[:3000], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
