"""S WebSocket sessions against the product's pool server, open loop:
the pool's load generator.  No cell of BENCHMARK.json runs it yet
(PERF.md, Open questions); a pool cell needs only its manifest entries
and a limits file.  It reports ``block_p99_ms`` over every session's due
blocks, as the live cells do.

The server is ``python -m aefs_tpu_torch.server.pool --config <chain>
--slots S --port <free>``, started through ``benchmark/pool_server.py``
(which records the serving layer's spans) in a process of its own, the
only one on the card.  The sessions run in generator processes (their
count from ``os.cpu_count()``), each an asyncio loop of websocket
clients.  Session s has a block due every block period from its own
phase offset; it sends the newest due block when its previous reply has
come (skipping older ones) and holds that block's output when the
``processed_block`` reply arrives.

A pool steps every slot at every step, idle slots on silence, so a
slot's audio is the sequence of steps since the server started, with the
session's blocks where it took part; the server's step record gives that
sequence, and the reference renders it for a sample of sessions drawn
from the seed.  Every reply is checked for its shape; the sampled
sessions' outputs are compared.
"""

from __future__ import annotations

import asyncio
import json
import multiprocessing as mp
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..audio import seed_of
from ..harness import HERE, ROOT, BenchError, Outcome, pct
from ..refchain import render_mono
from ..streams import err_dbfs, latencies, session_inputs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _session(url, mono, origin, period, k_stop, keep, block):
    import websockets

    rec = {"handed": [], "sent": [], "reply": [], "outputs": [] if keep else None,
           "bad": 0, "slot": None}
    async with websockets.connect(url, max_size=2 ** 26, ping_interval=None) as ws:
        ready = json.loads(await ws.recv())
        rec["slot"] = ready["slot"]
        k_next = 0
        while True:
            now = time.monotonic()
            newest = int((now - origin) / period)
            if newest < k_next:
                await asyncio.sleep(origin + k_next * period - now)
                continue
            if newest >= k_stop:
                break
            audio = mono[newest * block: (newest + 1) * block]
            t_send = time.monotonic()
            await ws.send(json.dumps({"command": "stream_block", "audio": audio.tolist()}))
            msg = json.loads(await ws.recv())
            t_reply = time.monotonic()
            rec["handed"].append(newest)
            rec["sent"].append(t_send)
            rec["reply"].append(t_reply)
            out = np.stack([np.asarray(msg.get("output", ()), np.float32),
                            np.asarray(msg.get("output_r", ()), np.float32)])
            if msg.get("type") != "processed_block" or out.shape != (2, block) \
                    or not np.all(np.isfinite(out)):
                rec["bad"] += 1
            if keep:
                rec["outputs"].append(out)
            k_next = newest + 1
    return rec


def _generator(url, seed, sessions, n_sessions, samples, fs, block, origin, offsets,
               k_stop, keep, out_q):
    """One generator process: its share of the sessions on one loop."""
    monos = session_inputs(seed, n_sessions, samples, fs, sessions)
    period = block / fs

    async def main():
        return await asyncio.gather(*[
            _session(url, monos[s], origin + offsets[s], period, k_stop, s in keep, block)
            for s in sessions])

    recs = asyncio.run(main())
    out_q.put({s: r for s, r in zip(sessions, recs)})


def _wait_port(port, proc, log, timeout):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if proc.poll() is not None:
            raise BenchError(f"the pool server exited ({proc.returncode}):\n{_tail(log)}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.2)
    raise BenchError(f"the pool server did not listen within {timeout} s:\n{_tail(log)}")


def _tail(path, n=4000):
    try:
        return Path(path).read_text(errors="replace")[-n:]
    except OSError:
        return ""


def slot_stream(steps, slot, blocks):
    """A slot's input over every step: the session's blocks, in order,
    where it took part, silence elsewhere; and the positions of its own.
    Returns (samples,) float64, [step positions]."""
    mine = [i for i, (_t, _d, slots) in enumerate(steps) if slot in slots]
    if len(mine) != len(blocks):
        raise BenchError(f"slot {slot}: {len(mine)} steps took part, {len(blocks)} blocks sent")
    last = mine[-1] + 1 if mine else 0
    block = blocks.shape[1] if len(blocks) else 0
    x = np.zeros((last, block))
    x[mine] = blocks
    return x.reshape(-1), mine


def run(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    fs, block = cfg["sample_rate"], cfg["blocksize"]
    period = block / fs
    n_sess = tr["sessions"]
    warm = tr["warmup_blocks"]
    k_lo, k_hi = warm, warm + int(ctx.seconds / period)
    post = tr["trace_blocks"] if ctx.trace else 0
    k_stop = k_hi + post + tr["slack_blocks"]
    samples = (k_stop + 2) * block
    rng = np.random.default_rng(seed_of(ctx.seed, 7))
    offsets = rng.uniform(0.0, period, n_sess)
    keep = set(rng.choice(n_sess, size=min(tr["compare_sessions"], n_sess),
                          replace=False).tolist())
    n_gen = max(1, min(n_sess, (os.cpu_count() or 2) // 2 - 1))

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, report = os.path.join(tmp, "chain.json"), os.path.join(tmp, "report.json")
        log = os.path.join(tmp, "server.log")
        with open(cfg_path, "w") as f:
            json.dump(cfg["chain"], f)
        port = _free_port()
        cmd = [sys.executable, str(HERE / "pool_server.py"), "--report", report]
        # The trace's start is known once the port listens: the server's
        # profiler thread waits for it in this file.
        trace_file = os.path.join(tmp, "trace_at")
        if ctx.trace:
            cmd += ["--trace-file", trace_file, "--trace-s", str(tr["trace_s"])]
        procs = []
        with open(log, "w") as lf:
            server = subprocess.Popen(
                cmd + ["--", "--config", cfg_path, "--slots", str(n_sess), "--port", str(port)]
                + (["--device", "cpu"] if ctx.device == "cpu" else []),
                stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        try:
            _wait_port(port, server, log, tr["server_start_timeout_s"])
            origin = time.monotonic() + tr["connect_margin_s"]
            if ctx.trace:
                with open(trace_file + ".tmp", "w") as f:
                    f.write(repr(origin + k_hi * period + tr["trace_delay_s"]))
                os.replace(trace_file + ".tmp", trace_file)
            url = f"ws://127.0.0.1:{port}"
            mpc = mp.get_context("spawn")
            q = mpc.Queue()
            groups = [list(range(g, n_sess, n_gen)) for g in range(n_gen)]
            procs = [mpc.Process(target=_generator, daemon=True, args=(
                url, ctx.seed, grp, n_sess, samples, fs, block, origin, offsets, k_stop,
                keep, q)) for grp in groups]
            for p in procs:
                p.start()
            setup_s = origin + k_lo * period - ctx.started
            ctx.log(generators=n_gen, cpu_count=os.cpu_count(), sessions=n_sess,
                    origin_in_s=origin - time.monotonic())
            recs = {}
            deadline = origin + k_stop * period + tr["drain_timeout_s"]
            while len(recs) < n_sess:
                try:
                    recs.update(q.get(timeout=max(1.0, deadline - time.monotonic())))
                except queue.Empty as e:  # a generator died or hung
                    raise BenchError(f"generators returned {len(recs)} of {n_sess} "
                                     f"sessions: {e!r}") from e
            for p in procs:
                p.join(timeout=30)
            server.send_signal(signal.SIGTERM)
            server.wait(timeout=60)
            with open(report) as f:
                rep = json.load(f)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            if server.poll() is None:
                server.kill()
                server.wait()
        if ctx.trace and rep.get("trace") is None:
            print(_tail(log), flush=True)

    t_w, t_end = origin + k_lo * period, origin + k_hi * period
    steps = rep["steps"]
    in_win = [s for s in steps if t_w <= s[0] < t_end]
    lat_all, late, skipped_n, failed, slack = [], 0, 0, 0, []
    for s, r in recs.items():
        o = origin + offsets[s]
        lat, skipped = latencies(r["handed"], r["reply"], o, period, k_lo, k_hi)
        lat_all.append(lat)
        late += int((skipped | (lat > tr["late_periods"] * period)).sum())
        skipped_n += int(skipped.sum())
        failed += r["bad"] + int(np.sum(~np.isfinite(lat)))
        slack += [t - (o + k * period) for i, (k, t) in enumerate(zip(r["handed"], r["sent"]))
                  if k_lo <= k < k_hi and i and r["reply"][i - 1] < o + k * period]
    lat_all = np.concatenate(lat_all)
    monos = session_inputs(ctx.seed, n_sess, samples, fs, keep)
    worst = control = 0.0  # the control's outputs in the program's place
    kept = sorted(keep)
    if any(not recs[s]["handed"] for s in kept):
        worst = np.inf
    for i in range(0, len(kept), 4):
        group = [s for s in kept[i: i + 4] if recs[s]["handed"]]
        if not group:
            continue
        streams = [slot_stream(steps, recs[s]["slot"],
                               monos[s].reshape(-1, block)[recs[s]["handed"]]) for s in group]
        n = max(len(x) for x, _ in streams)
        batch = np.zeros((len(group), n))
        for j, (x, _) in enumerate(streams):
            batch[j, : len(x)] = x
        ref = render_mono(batch, cfg["chain"], fs)
        low = render_mono(batch, cfg["chain"], fs, ctx.control) if ctx.control else None
        for j, s in enumerate(group):
            pos = np.asarray(streams[j][1])
            r = ref[j].reshape(2, -1, block)[:, pos]  # (2, blocks, block)
            got = np.stack(recs[s]["outputs"], axis=1)  # (2, blocks, block)
            worst = max(worst, float(np.max(np.abs(got - r))))
            if low is not None:
                control = max(control, float(np.max(np.abs(
                    low[j].reshape(2, -1, block)[:, pos] - r))))

    trace = rep.get("trace")
    return Outcome(
        setup_s=setup_s,
        attempted=(k_hi - k_lo) * n_sess,
        failed=failed,
        e2e={"block_p99_ms": 1000.0 * pct(lat_all, 99)},
        obs={"spans": {"pool_step_s": [d for _t, d, _s in in_win]},
             "counters": {"due_blocks": (k_hi - k_lo) * n_sess, "late_blocks": late,
                          "skipped_blocks": skipped_n, "steps": len(in_win),
                          "blocks_stepped": sum(len(sl) for _t, _d, sl in in_win)},
             "trace": trace, "shapes": {"slots": n_sess, "block": block, "fs": fs}},
        checks={"err_dbfs": err_dbfs(worst)},
        control_checks={"err_dbfs": err_dbfs(control)} if ctx.control else {},
        memory_peak_bytes=rep["peak"], device_kind=rep["kind"], device_count=rep["count"],
        notes={"sessions": n_sess, "generators": n_gen, "compared_sessions": kept,
               "steps_in_window": len(in_win), "skipped": skipped_n, "late": late,
               "due": (k_hi - k_lo) * n_sess,
               "blocks_per_step": sum(len(sl) for _t, _d, sl in in_win) / max(1, len(in_win)),
               "step_p50_ms": 1000.0 * (pct([d for _t, d, _s in in_win], 50) or 0.0),
               "generator_late_p99_ms": 1000.0 * (pct(slack, 99) or 0.0),
               "generator_late_max_ms": 1000.0 * max(slack, default=0.0),
               "block_p50_ms": 1000.0 * pct(lat_all, 50)},
    )
