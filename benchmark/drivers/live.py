"""One musician's mic path, open loop: a block of mono samples falls due
every block period on the audio clock, and one thread hands the newest
due block to ``AudioEngine.process_stream_block_pipelined`` (the mic
stream's default step), which returns the previous block's output.

The stream starts in set-up (the warm-up blocks are its first blocks), is
measured over the window, and runs on until the client holds the output
of a block due after the window; with ``--trace 1`` it then runs on under
the profiler for ``trace_blocks`` more blocks.  Every block handed over
is one stream from a fresh chain: the reference renders that stream and
every output the program returned is compared with it.

Two end-to-end numbers: ``block_p99_ms``, the tail over every due block,
for a chain whose call fits the block period; and ``stream_x_realtime``,
the audio whose output the client held within the window (one block
period a block) per second of the window, for a chain whose call does not
fit, where most blocks are skipped and the tail follows the call time.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ..harness import Outcome, pct
from ..refchain import render_mono
from ..streams import err_dbfs, latencies, session_inputs
from .. import tracing


def _drive(step, blocks, origin, period, k_next, stop, record):
    """Hand blocks at the audio clock until ``stop(k_handed)`` is true;
    ``record(k, t_call, t_ret, out)`` sees every call."""
    while True:
        now = time.perf_counter()
        newest = int((now - origin) / period)
        if newest < k_next:
            # Spin to the due time, as an audio callback thread waits: a
            # sleeping thread wakes up late on a busy host.
            due = origin + k_next * period
            while time.perf_counter() < due:
                pass
            continue
        if newest >= len(blocks):  # the input ran out: blocks left unanswered count
            return k_next
        t_call = time.perf_counter()
        out = step(blocks[newest])
        record(newest, t_call, time.perf_counter(), out)
        k_next = newest + 1
        if stop(newest):
            return k_next


def _gap(got, ref):
    """The worst gap (dBFS) of the outputs from the reference's."""
    return err_dbfs(float(np.max(np.abs(got - ref))))


def run(ctx):
    import torch

    from aefs_tpu_torch.engine.engine import AudioEngine

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    fs, block = cfg["sample_rate"], cfg["blocksize"]
    period = block / fs
    warm = tr["warmup_blocks"]
    k_lo = warm
    k_hi = warm + int(ctx.seconds / period)
    post = tr["trace_blocks"] if ctx.trace else 0
    n_blocks = k_hi + 2 * post + tr["slack_blocks"]
    mono = session_inputs(ctx.seed, 1, n_blocks * block, fs)[0]
    blocks = mono.reshape(n_blocks, block, 1)

    inputs = time.perf_counter()
    eng = AudioEngine(device=ctx.device)
    eng.build_chain(cfg["chain"])
    step = eng.process_stream_block_pipelined
    handed, t_calls, t_rets, outs = [], [], [], []

    def record(k, t_call, t_ret, out):
        handed.append(k)
        t_calls.append(t_call)
        t_rets.append(t_ret)
        outs.append(out)

    built = time.perf_counter()
    # gc off while the stream runs, as the backend serves (backend.main)
    gc.collect()
    gc.disable()
    origin = time.perf_counter()
    k_next = _drive(step, blocks, origin, period, 0, lambda k: k >= warm - 1, record)
    setup_s = origin + k_lo * period - ctx.started
    # The window: until the client holds the output of a block due after it
    # (it comes back with the call after that block's own).
    n_before = len(handed)
    k_next = _drive(step, blocks, origin, period, k_next,
                    lambda k: len(handed) >= 2 and handed[-2] >= k_hi, record)
    gc.enable()
    dev = torch.device(ctx.device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if post:
        n0 = len(handed)
        with tracing.profiler() as prof:
            # The profiler's start takes a while: the stream resumes with the
            # next block due now (a block index that the clock does not skip).
            tracing.mark(tracing.START)
            resumed = time.perf_counter() - k_next * period
            _drive(step, blocks, resumed, period, k_next,
                   lambda k: len(handed) >= n0 + post or k >= n_blocks - 2, record)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tracing.mark(tracing.END)
        trace = tracing.summarize(prof)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    eng.close()
    del eng, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # handed[i]'s output comes back with call i + 1.
    reply_t = t_rets[1:] + [None]
    lat, skipped = latencies(handed, reply_t, origin, period, k_lo, k_hi)
    t_w, t_end = origin + k_lo * period, origin + k_hi * period
    served = sum(1 for t in reply_t if t is not None and t_w <= t < t_end)
    bad = [i for i, o in enumerate(outs)
           if o is None or o.shape != (block, 2) or not np.all(np.isfinite(o))]
    failed = len(bad) + int(np.sum(~np.isfinite(lat)))
    late = skipped | (lat > tr["late_periods"] * period)
    window_calls = [i for i in range(n_before, len(handed)) if handed[i] < k_hi]
    service = [t_rets[i] - t_calls[i] for i in window_calls]
    # How late the generator ran: calls made while it was waiting for the
    # block's due time (not those that a slow previous call delayed).
    slack = [t_calls[i] - (origin + handed[i] * period) for i in window_calls
             if t_rets[i - 1] < origin + handed[i] * period]

    # Every output returned is one stream: the blocks handed over, in order.
    stream = blocks[handed[:-1], :, 0].reshape(-1)
    got = np.concatenate([o.T for o in outs[1:]], axis=1)
    ref = render_mono(stream, cfg["chain"], fs)
    checks = {"err_dbfs": _gap(got, ref) if not bad else np.inf}
    control = {}
    if ctx.control:  # the control's stream in the program's place
        control = {"err_dbfs": _gap(render_mono(stream, cfg["chain"], fs, ctx.control), ref)}
    return Outcome(
        setup_s=setup_s,
        attempted=k_hi - k_lo,
        failed=failed,
        e2e={"block_p99_ms": 1000.0 * pct(lat, 99),
             "stream_x_realtime": served * period / (t_end - t_w)},
        obs={"spans": {"block_service_s": service},
             "counters": {"due_blocks": k_hi - k_lo, "late_blocks": int(late.sum()),
                          "skipped_blocks": int(skipped.sum()),
                          "block_p99_ms": 1000.0 * pct(lat, 99)},
             "trace": trace, "shapes": {"slots": 1, "block": block, "fs": fs}},
        checks=checks,
        control_checks=control,
        memory_peak_bytes=peak, device_kind=kind, device_count=1,
        notes={"handed": len(handed), "compared_blocks": len(outs) - 1,
               "skipped": int(skipped.sum()), "late": int(late.sum()),
               "generator_late_p99_ms": 1000.0 * (pct(slack, 99) or 0.0),
               "generator_late_max_ms": 1000.0 * max(slack, default=0.0),
               **{f"block_p{q}_ms": 1000.0 * pct(lat, q) for q in (50, 90, 95, 99.9)},
               "setup_phases_s": {"imports_inputs": inputs - ctx.started,
                                  "engine_build": built - inputs,
                                  "warmup": origin + k_lo * period - built}},
    )
