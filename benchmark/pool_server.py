"""Starts the product's pool server, ``aefs_tpu_torch.server.pool``'s
``main`` with the arguments after ``--``, with the serving layer's spans
installed at run time (the program is not edited): every
``SessionPool.step_blocks_pipelined`` call is recorded with its start,
its duration and the slots whose blocks it stepped.  With
``--trace-file`` a thread waits for that file, reads a CLOCK_MONOTONIC
time from it and runs ``torch.profiler`` from then for ``--trace-s``
seconds.  On SIGTERM it writes the spans, the trace's
summary, the card's name and its peak memory to ``--report`` and exits.

    python3 benchmark/pool_server.py --report R.json -- --config C.json --slots 32 --port P
"""

import argparse
import asyncio
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace-file", default=None)
    ap.add_argument("--trace-s", type=float, default=1.5)
    ap.add_argument("pool_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    pool_args = [a for a in args.pool_args if a != "--"]

    import torch

    from aefs_tpu_torch.server import pool as pool_mod

    from benchmark import tracing

    steps = []
    original = pool_mod.SessionPool.step_blocks_pipelined

    def step_blocks_pipelined(self, blocks):
        t0 = time.monotonic()
        try:
            return original(self, blocks)
        finally:
            steps.append((t0, time.monotonic() - t0, sorted(blocks)))

    pool_mod.SessionPool.step_blocks_pipelined = step_blocks_pipelined
    traced = {}

    def profile_later():
        while not os.path.exists(args.trace_file):
            time.sleep(0.1)
        with open(args.trace_file) as f:
            start = float(f.read())
        time.sleep(max(0.0, start - time.monotonic()))
        with tracing.profiler() as prof:
            tracing.mark(tracing.START)
            time.sleep(args.trace_s)
            torch.cuda.synchronize()
            tracing.mark(tracing.END)
        traced["summary"] = tracing.summarize(prof)

    if args.trace_file is not None:
        threading.Thread(target=profile_later, daemon=True).start()

    def finish(signum, frame):
        report = {"steps": steps, "trace": traced.get("summary"),
                  "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
                  "count": 1,
                  "peak": torch.cuda.max_memory_allocated(0) if torch.cuda.is_available() else 0}
        tmp = args.report + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, args.report)
        sys.stdout.flush()
        os._exit(0)

    signal.signal(signal.SIGTERM, finish)
    asyncio.run(pool_mod.main(pool_args))


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
