"""The port's tracer (``aefs_tpu_torch/utils/metrics.py:TRACER``) on the CPU:
off it records nothing and hands out one no-op span; its rings wrap and
count what they dropped; under a ``torch.profiler`` session an enabled
span is a host event of its name and duration, and a profiler alone
turns nothing on; a span shifted by the exported clock offset lies on
the profiler's timeline, from any thread; ``hop`` times an executor's
two ways and is ``fn`` itself while off; an upload through the backend's
``handler`` gives each front span once under one request id, its two
hops four ``front.hop`` spans and its serialize's parts nested inside
it, and the same reply bytes traced or not; the mic
path's ``engine.block`` is ``BlockTimer``'s own reading; the pool's
batcher counts its blocks, drop-late and steps, and ``last_step_ms`` is
its ``pool.step`` span; a whole-file render spans each effect in turn,
and a streaming block does not; ``get_stats`` /
``get_pool_stats`` carry ``"trace"`` only while the tracer is enabled."""

import asyncio
import base64
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline
from aefs_tpu_torch.engine.wavio import encode_wav_int16
from aefs_tpu_torch.server import backend
from aefs_tpu_torch.server.pool import PoolServer, SessionPool, _Batcher
from aefs_tpu_torch.utils import metrics
from aefs_tpu_torch.utils.metrics import NO_SPAN, TRACER, Tracer

FS = 48000
CFG = [{"effect_id": "f", "type": "filter",
        "params": {"filter_type": 0, "cutoff_hz": 1200, "q": 0.707}}]
FRONT = ("front.decode", "engine.render", "front.analysis", "front.serialize", "front.send")


@pytest.fixture(autouse=True)
def _clean_tracer(monkeypatch):
    """The process's tracer enabled and empty for the test, then off and
    empty again; the handlers on the CPU with one thread."""
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    TRACER.reset()
    TRACER.enable()
    yield
    TRACER.disable()
    TRACER.reset()
    torch.set_num_threads(prev)


class _Socket:
    """An in-memory websocket: the handler iterates ``inbox`` and ``send``s
    into ``sent``."""

    def __init__(self):
        self.inbox = asyncio.Queue()
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.inbox.get()
        if msg is None:
            raise StopAsyncIteration
        return msg

    async def reply(self, kind, timeout=120):
        """The first sent message of type ``kind``, parsed."""
        tag = f'{{"type": "{kind}"'
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            for msg in self.sent:
                if msg.startswith(tag):
                    return json.loads(msg)
            await asyncio.sleep(0.01)
        raise AssertionError(f"no {kind} reply")


def _url(seconds=0.5):
    x = 0.1 * np.random.default_rng(3).standard_normal((int(FS * seconds), 2))
    return "data:audio/wav;base64," + base64.b64encode(
        encode_wav_int16(x.astype(np.float32), FS)).decode()


def _serve(handler, script):
    """``script(sock)`` against ``handler`` over one in-memory socket."""
    async def main():
        sock = _Socket()

        async def client():
            try:
                return await script(sock)
            finally:
                await sock.inbox.put(None)

        return (await asyncio.gather(handler(sock), client()))[1]

    return asyncio.run(main())


# -- the tracer ------------------------------------------------------------------

def test_off_records_nothing_and_hands_out_one_noop_span():
    tr = Tracer()
    spans = [tr.span("a", 1), tr.span("b")]
    assert all(s is NO_SPAN for s in spans)
    with tr.span("a", 2) as s:
        s.close()
    tr.count("c", 3)
    tr.record("a", 1, tr.clock(), tr.clock())
    assert tr.clock() is None
    assert tr.export() == {"spans": {}, "counters": {}, "dropped": {},
                           "clock": {"trace_offset_ns": tr.offset_ns}}


def test_timed_reads_the_clock_off_and_keeps_only_on():
    tr = Tracer()
    off = tr.timed("x", 1)
    time.sleep(0.002)
    off.close()
    assert off.ns >= 2_000_000 and tr.export()["spans"] == {}
    tr.enable()
    with tr.timed("x", 2) as on:
        pass
    assert tr.export()["spans"]["x"] == [[2, on.t0, on.t0 + on.ns]]


def test_rings_wrap_and_count_dropped():
    tr = Tracer(capacity=4, enabled=True)
    for i in range(10):
        with tr.span("s", i):
            pass
    ex = tr.export()
    assert [rid for rid, _s, _e in ex["spans"]["s"]] == [6, 7, 8, 9]
    assert ex["dropped"] == {"s": 6}
    assert tr.snapshot()["spans"]["s"]["count"] == 10


def test_export_and_reset():
    tr = Tracer(enabled=True)
    with tr.span("outer", 7):
        with tr.span("inner", 7):
            time.sleep(0.001)
    tr.count("n")
    tr.count("n", 4)
    ex = tr.export()
    (_, o0, o1), = ex["spans"]["outer"]
    (rid, i0, i1), = ex["spans"]["inner"]
    assert rid == 7 and o0 <= i0 < i1 <= o1 and i1 - i0 >= 1_000_000
    assert ex["counters"] == {"n": 5} and ex["dropped"] == {"outer": 0, "inner": 0}
    snap = tr.snapshot()
    assert snap["spans"]["inner"]["p50_ms"] >= 1.0 and snap["counters"] == {"n": 5}
    json.dumps(snap)
    tr.reset()
    assert tr.export() == {"spans": {}, "counters": {}, "dropped": {},
                           "clock": {"trace_offset_ns": tr.offset_ns}}


def _host_events(prof, name):
    return [ev for ev in prof.profiler.kineto_results.events() if ev.name() == name]


def test_a_span_under_the_profiler_is_a_host_event_of_its_duration():
    tr = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("front.decode", 1) as span:
            time.sleep(0.005)
    ev, = _host_events(prof, "front.decode")
    assert span.ns <= ev.duration_ns() <= span.ns + 2_000_000
    # Not a user annotation, which the profiler would mirror on the device
    # timeline over the kernels the span encloses.
    assert not ev.is_user_annotation()


def test_no_profiler_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "_RecordFunctionFast", lambda name: opened.append(name))
    tr = Tracer(enabled=True)
    with tr.span("engine.stage", 1):
        pass
    assert opened == [] and len(tr.export()["spans"]["engine.stage"]) == 1


def test_a_profiler_session_alone_leaves_the_tracer_off():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("chain.replay", 3) as span:
            assert span is NO_SPAN
        tr.count("chain.captures")
        assert tr.clock() is None
    assert _host_events(prof, "chain.replay") == []
    assert tr.export() == {"spans": {}, "counters": {}, "dropped": {},
                           "clock": {"trace_offset_ns": tr.offset_ns}}


def test_a_timed_span_opens_a_range_only_when_enabled():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.timed("engine.block", 1) as off:
            pass
        tr.enable()
        with tr.timed("engine.block", 2):
            pass
    assert off.ns is not None
    assert len(_host_events(prof, "engine.block")) == 1
    assert [r for r, _s, _e in tr.export()["spans"]["engine.block"]] == [2]


def test_a_shifted_span_starts_with_its_mirror_range():
    tr = Tracer(enabled=True)
    off = tr.export()["clock"]["trace_offset_ns"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for rid in range(5):
            with tr.span("front.decode", rid):
                time.sleep(0.001)
    mirrors = sorted(ev.start_ns() for ev in _host_events(prof, "front.decode"))
    starts = [s + off for _r, s, _e in tr.export()["spans"]["front.decode"]]
    assert len(mirrors) == len(starts) == 5
    # The median: a thread switch between the range's start and the clock
    # read may part one pair on a loaded machine.
    assert statistics.median(abs(a - b) for a, b in zip(mirrors, starts)) < 200_000


def test_a_span_on_an_executor_thread_is_exported_on_the_same_clock():
    tr = Tracer(enabled=True)

    def work():
        before = time.time_ns()
        with tr.span("engine.render", 4):
            time.sleep(0.002)
        return before, time.time_ns()

    with ThreadPoolExecutor(1) as pool:
        before, after = pool.submit(work).result()
    ex = tr.export()
    off = ex["clock"]["trace_offset_ns"]
    (rid, s, e), = ex["spans"]["engine.render"]
    assert rid == 4 and before - 200_000 <= s + off < e + off <= after + 200_000
    tr.reset()
    assert tr.export()["clock"]["trace_offset_ns"] == tr.offset_ns
    assert abs(tr.offset_ns - off) < 200_000


def test_the_offset_is_read_at_reset_and_enable(monkeypatch):
    reads = []
    monkeypatch.setattr(metrics, "trace_offset_ns", lambda: reads.append(1) or 7 * len(reads))
    tr = Tracer()
    assert tr.offset_ns == 7
    tr.enable()
    assert tr.export()["clock"] == {"trace_offset_ns": 14}
    tr.reset()
    assert tr.export()["clock"] == {"trace_offset_ns": 21} and len(reads) == 3


def test_hop_off_is_fn_itself_and_reads_no_clock(monkeypatch):
    tr = Tracer()

    def fn(x):
        return x + 1

    def no_clock():
        raise AssertionError("a clock read")

    with monkeypatch.context() as m:
        m.setattr(metrics.time, "perf_counter_ns", no_clock)
        m.setattr(metrics.time, "time_ns", no_clock)
        call = tr.hop("front.hop", 1, fn)
        assert call is fn
        assert asyncio.run(_in_executor(call, 2)) == 3
        tr.landed(call)
    assert tr.export()["spans"] == {}


async def _in_executor(call, *args):
    return await asyncio.get_running_loop().run_in_executor(None, call, *args)


def test_hop_times_the_way_there_and_the_way_back():
    tr = Tracer(enabled=True)
    seen = {}

    def fn(x):
        seen["start"] = time.perf_counter_ns()
        time.sleep(0.002)
        seen["end"] = time.perf_counter_ns()
        return 2 * x

    async def main():
        call = tr.hop("front.hop", 9, fn)
        out = await _in_executor(call, 5)
        tr.landed(call)
        return call, out, time.perf_counter_ns()

    call, out, resumed = asyncio.run(main())
    assert out == 10 and call.fn is fn
    (r0, a0, a1), (r1, b0, b1) = tr.export()["spans"]["front.hop"]
    assert r0 == r1 == 9
    assert a0 == call.t0 <= a1 <= seen["start"]  # the submit to the worker's start
    assert seen["end"] <= b0 == call.t1 <= b1 <= resumed  # the return to the loop again


@pytest.mark.parametrize("env, on", [("1", True), ("0", False), (None, False)])
def test_aefs_trace_switches_the_tracer_at_import(env, on):
    environ = {k: v for k, v in os.environ.items() if k != "AEFS_TRACE"}
    if env is not None:
        environ["AEFS_TRACE"] = env
    out = subprocess.run([sys.executable, "-c", "from aefs_tpu_torch.utils.metrics import "
                          "TRACER; print(TRACER.enabled)"], env=environ, capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == str(on), out.stderr[-2000:]


# -- the upload's front ------------------------------------------------------------

def test_an_upload_gives_each_front_span_once_inside_front_upload():
    async def script(sock):
        await sock.inbox.put(json.dumps({"command": "build_chain", "config": CFG}))
        await sock.inbox.put(json.dumps({"command": "process_file", "contents": _url()}))
        await sock.reply("file_processed")
        return next(m for m in sock.sent if m.startswith('{"type": "file_processed"'))

    reply = _serve(backend.handler, script)
    ex = TRACER.export()
    (rid, u0, u1), = ex["spans"]["front.upload"]
    for name in FRONT:
        (r, s, e), = ex["spans"][name]
        assert r == rid and u0 <= s <= e <= u1, name
    ordered = sorted(ex["spans"][n][0][1:] for n in FRONT)
    assert all(a[1] <= b[0] for a, b in zip(ordered, ordered[1:]))  # no two overlap
    assert ex["counters"]["front.uploads"] == 1
    assert ex["counters"]["front.reply_bytes"] == len(reply)


def test_an_upload_hops_four_times_and_splits_its_serialize():
    eng = AudioEngine(device="cpu")
    eng.build_chain(CFG)
    asyncio.run(eng.process_wav_file(_url(), _Socket()))
    eng.close()
    sp = TRACER.export()["spans"]
    (rid, u0, u1), = sp["front.upload"]
    hops = sp["front.hop"]
    assert len(hops) == 4 and {r for r, _s, _e in hops} == {rid}
    assert all(u0 <= s <= e <= u1 for _r, s, e in hops)
    (_r, r0, r1), = sp["engine.render"]
    (_r, z0, z1), = sp["front.serialize"]
    # There, the render, back; there, the analysis and the serialize, back.
    (h0, h1), (h2, h3), (h4, h5), (h6, h7) = sorted((s, e) for _r, s, e in hops)
    assert h1 <= r0 and r1 <= h2 and h3 <= h4 and h5 <= z0 and z1 <= h6 <= h7 <= u1
    parts = []
    for name in ("front.wav", "front.b64", "front.reply"):
        (r, s, e), = sp[name]
        assert r == rid and z0 <= s <= e <= z1, name
        parts.append((s, e))
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))  # in turn, apart
    (r, s, e), = sp["front.samples"]
    assert r == rid and parts[2][0] <= s <= e <= parts[2][1]


def test_the_reply_is_the_same_bytes_traced_or_not():
    url = _url(0.3)
    replies = []
    for on in (True, False, True):
        TRACER.enable() if on else TRACER.disable()
        eng = AudioEngine(device="cpu")
        eng.build_chain(CFG)
        sock = _Socket()
        asyncio.run(eng.process_wav_file(url, sock))
        eng.close()
        (reply,) = sock.sent
        replies.append(reply)
    assert replies[0].startswith('{"type": "file_processed"')
    assert replies[0] == replies[1] == replies[2]
    assert len(TRACER.export()["spans"]["front.upload"]) == 2


def test_a_direct_upload_opens_its_own_front_span():
    eng = AudioEngine(device="cpu")
    eng.build_chain(CFG)
    sock = _Socket()
    asyncio.run(eng.process_wav_file(_url(0.2), sock))
    spans = TRACER.export()["spans"]
    assert len(spans["front.upload"]) == 1
    assert {spans[n][0][0] for n in FRONT} == {spans["front.upload"][0][0]}
    eng.close()


# -- the mic path ------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [True, False])
def test_engine_block_is_the_block_timers_reading(pipelined):
    eng = AudioEngine(device="cpu")
    eng.build_chain(CFG)
    step = eng.process_stream_block_pipelined if pipelined else eng.process_stream_block
    x = 0.1 * np.random.default_rng(1).standard_normal((6, 256, 1)).astype(np.float32)
    for blk in x:
        step(blk)
    ex = TRACER.export()
    blocks = ex["spans"]["engine.block"]
    assert [(e - s) / 1e9 for _r, s, e in blocks] == list(eng.metrics._times[:6])
    rids = [r for r, _s, _e in blocks]
    assert len(set(rids)) == 6
    for name in ("engine.stage", "chain.replay", "engine.readback", "engine.tap"):
        assert [r for r, _s, _e in ex["spans"][name]] == rids, name
    collected = [r for r, _s, _e in ex["spans"]["engine.collect"]]
    assert collected == (rids[1:] if pipelined else rids)
    assert ex["counters"]["engine.blocks"] == 6
    assert ex["counters"].get("engine.silent_blocks", 0) == (1 if pipelined else 0)
    eng.close()


# -- the whole-file pass ------------------------------------------------------------

# "Jet Flanger" after a filter: two effects, the flanger second.
FILE_CFG = CFG + DEFAULT_PRESETS["Jet Flanger"]


def _render_file(frames=5000):
    x = 0.1 * np.random.default_rng(4).standard_normal((frames, 2)).astype(np.float32)
    process_offline(FILE_CFG, x, FS, device="cpu")


def test_a_file_render_spans_each_effect_in_turn():
    _render_file()
    ex = TRACER.export()
    spans = ex["spans"]["chain.file_effect"]
    assert [r for r, _s, _e in spans] == [0, 1]
    (_r0, s0, e0), (_r1, s1, e1) = spans
    assert s0 <= e0 <= s1 <= e1
    assert ex["counters"] == {}


def test_a_file_render_off_records_nothing():
    TRACER.disable()
    _render_file()
    assert TRACER.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": TRACER.offset_ns}}


def test_a_streaming_block_keeps_no_file_span():
    chain, state, tmap = build_chain(FILE_CFG, FS, 256, device="cpu")
    chain.process_block(state, chain.targets(tmap), torch.zeros(1, 256))
    assert TRACER.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": TRACER.offset_ns}}


# -- the pool's batcher ------------------------------------------------------------

def test_pool_counts_blocks_drop_late_and_steps():
    pool = SessionPool(CFG, n_slots=4, device="cpu")
    slots = [pool.claim() for _ in range(3)]
    blk = np.full(pool.blocksize, 0.1, np.float32)

    async def main():
        batcher = _Batcher(pool)
        task = asyncio.create_task(batcher.run())
        try:
            # Two submissions of one slot before a batch is taken: the first
            # is dropped late.
            first = asyncio.ensure_future(batcher.submit(slots[0], blk))
            await asyncio.sleep(0)
            results = await asyncio.gather(*(batcher.submit(s, blk) for s in slots))
            with pytest.raises(RuntimeError, match="superseded"):
                await first
            for _ in range(3):
                results += await asyncio.gather(*(batcher.submit(s, blk) for s in slots))
            return results
        finally:
            task.cancel()

    results = asyncio.run(main())
    ex = TRACER.export()
    c = ex["counters"]
    assert c["pool.superseded"] == 1
    assert c["pool.blocks"] == 13 - c["pool.superseded"] == len(ex["spans"]["pool.wait"])
    assert c["pool.steps"] == pool.generation == len(ex["spans"]["pool.step"])
    _r, s, e = ex["spans"]["pool.step"][-1]
    assert pool.last_step_ms == (e - s) / 1e6
    steps = {r for r, _s, _e in ex["spans"]["pool.step"]}
    assert {r for r, _s, _e in ex["spans"]["pool.wait"]} <= steps
    assert {gen for _out, gen, _t in results} <= steps
    assert {r for r, _s, _e in ex["spans"]["pool.deliver"]} <= steps
    assert len(ex["spans"]["pool.executor"]) >= c["pool.steps"]
    pool.close()


def test_pool_reply_spans_per_block_over_the_handler():
    pool = SessionPool(CFG, n_slots=2, device="cpu")
    srv = PoolServer(pool)
    blk = [0.1] * pool.blocksize

    async def script(sock):
        batcher = asyncio.create_task(srv.batcher())
        try:
            await sock.reply("session_ready")
            for _ in range(4):
                n = len(sock.sent)
                await sock.inbox.put(json.dumps({"command": "stream_block", "audio": blk}))
                while len(sock.sent) == n:
                    await asyncio.sleep(0.005)
        finally:
            batcher.cancel()

    _serve(srv.handler, script)
    ex = TRACER.export()
    steps = {r for r, _s, _e in ex["spans"]["pool.step"]}
    replies = ex["spans"]["pool.reply"]
    assert len(replies) == 4 and {r for r, _s, _e in replies} <= steps
    pool.close()


# -- the stats replies -------------------------------------------------------------

@pytest.mark.parametrize("enabled", [False, True])
def test_get_stats_carries_trace_only_when_enabled(enabled):
    if not enabled:
        TRACER.disable()

    async def script(sock):
        await sock.inbox.put(json.dumps({"command": "get_stats"}))
        return await sock.reply("stats")

    stats = _serve(backend.handler, script)
    keys = {"type", "engine", "is_running", "sample_rate", "plot_drops"}
    assert set(stats) == (keys | {"trace"} if enabled else keys)
    if enabled:
        assert set(stats["trace"]) == {"spans", "counters", "dropped"}


@pytest.mark.parametrize("enabled", [False, True])
def test_get_pool_stats_carries_trace_only_when_enabled(enabled):
    if not enabled:
        TRACER.disable()
    pool = SessionPool(CFG, n_slots=2, device="cpu")
    srv = PoolServer(pool)

    async def script(sock):
        batcher = asyncio.create_task(srv.batcher())
        try:
            await sock.reply("session_ready")
            await sock.inbox.put(json.dumps({"command": "stream_block",
                                             "audio": [0.0] * pool.blocksize}))
            await sock.reply("processed_block")
            await sock.inbox.put(json.dumps({"command": "get_pool_stats"}))
            return await sock.reply("pool_stats")
        finally:
            batcher.cancel()

    stats = _serve(srv.handler, script)
    keys = {"type", "slots", "active", "blocksize", "step_ms", "deadline_ms", "realtime_ok",
            "chain", "n_buckets", "total_step_ms", "buckets"}
    assert set(stats) == (keys | {"trace"} if enabled else keys)
    if enabled:
        assert stats["trace"]["spans"]["pool.step"]["count"] >= 1
        assert stats["trace"]["counters"]["pool.blocks"] == 1
    pool.close()
