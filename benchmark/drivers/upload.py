"""One UI user uploading recordings, closed loop: each upload is the next
seeded stereo recording, sent as a WAV data URL in a ``process_file``
command to the backend's ``handler`` (driven in-process through an
in-memory websocket), and timed until its ``file_processed`` reply is
passed to ``send``; the next upload goes when the reply has come.

``upload_x_realtime`` is the audio seconds of the uploads whose reply
came within the window over the time from the window's start to the last
such reply.  With ``--trace 1`` one more upload runs under the profiler
after the window.  A sample of the window's uploads, drawn from the seed,
is compared with the reference: the reply's WAV and its plotted mono mix.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import time

import numpy as np

from ..audio import read_wav_data_url, seed_of, to_int16, wav_data_url, rain_scene
from ..harness import Outcome, pct
from ..refchain import render_mono
from ..streams import err_dbfs
from .. import tracing

REPLY = '{"type": "file_processed"'


class _Socket:
    """An in-memory websocket: ``handler`` iterates the client's messages
    and ``send``s its replies; a ``file_processed`` reply is kept whole
    (unparsed) with the time it was passed to ``send``."""

    def __init__(self):
        self.inbox = asyncio.Queue()
        self.replies = []
        self.arrived = asyncio.Event()

    async def send(self, msg):
        if msg.startswith(REPLY):
            self.replies.append((time.perf_counter(), msg))
            self.arrived.set()

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.inbox.get()
        if msg is None:
            raise StopAsyncIteration
        return msg

    async def upload(self, url):
        """Send one upload; returns (t_send, t_reply, reply)."""
        n = len(self.replies)
        self.arrived.clear()
        t_send = time.perf_counter()
        await self.inbox.put(json.dumps({"command": "process_file", "contents": url}))
        while len(self.replies) == n:
            await self.arrived.wait()
            self.arrived.clear()
        t_reply, reply = self.replies[n]
        return t_send, t_reply, reply


def _field(reply: str, key: str) -> str:
    """A string field of the reply, found without parsing the whole JSON."""
    tag = f'"{key}": "'
    i = reply.index(tag) + len(tag)
    return reply[i: reply.index('"', i)]


def _check(reply: str, frames: int):
    """The reply's WAV as (frames, 2) int16; raises when malformed or of the
    wrong length."""
    pcm, _fs = read_wav_data_url(_field(reply, "processed_b64"))
    if pcm.shape != (frames, 2):
        raise ValueError(f"processed WAV {pcm.shape}, expected ({frames}, 2)")
    return pcm


def _as_reply(audio):
    """(2, frames) audio as a reply carries it: the 16-bit WAV (clipped,
    times 32767, truncated), read as code / 32767, and the plotted mono
    mix (the channels' float32 mean, to 5 significant digits)."""
    a = np.asarray(audio, np.float32)
    wav = np.trunc(np.clip(a, -1.0, 1.0) * np.float32(32767.0)).astype(np.float64) / 32767.0
    mix = a.mean(axis=0, dtype=np.float32).astype(np.float64)
    q = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(mix), 1e-30))) - 4)
    return wav, np.round(mix / q) * q


def _gap(wav, plot, ref):
    """The worst gap (dBFS) of a reply's WAV (2, frames) and its plotted
    mono mix from the reference's audio (2, frames)."""
    return err_dbfs(max(float(np.max(np.abs(wav - ref))),
                        float(np.max(np.abs(plot - ref.mean(axis=0))))))


def run(ctx):
    import torch

    from aefs_tpu_torch.engine import engine as engine_mod
    from aefs_tpu_torch.server import backend

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    fs = cfg["sample_rate"]
    frames = int(tr["upload_seconds"] * fs)
    hop = int(tr["offset_seconds"] * fs)
    n_up = tr["warmup_uploads"] + tr["uploads"]
    scene = rain_scene((frames + hop * n_up) / fs + 0.01, fs, seed_of(ctx.seed, 3))
    pcms = [to_int16(scene[i * hop: i * hop + frames]) for i in range(n_up)]
    urls = [wav_data_url(p, fs) for p in pcms]
    del scene

    def url(i):
        """Upload i; past the prepared ones (a window that outruns them),
        a prepared one turned over and rotated, made while the loop waits."""
        while i >= len(urls):
            j = len(urls)
            pcms.append(np.roll(np.maximum(pcms[j % n_up], -32767) * -1, 997 * j, axis=0)
                        .astype(np.int16))
            urls.append(wav_data_url(pcms[j], fs))
        return urls[i]

    # The engine span: a wrapper around the file render, installed at run
    # time (the program is not edited).
    renders = []
    original = engine_mod.AudioEngine.process_file_array

    def process_file_array(self, audio, rate):
        t0 = time.perf_counter()
        try:
            return original(self, audio, rate)
        finally:
            renders.append(time.perf_counter() - t0)

    engine_mod.AudioEngine.process_file_array = process_file_array
    if ctx.device == "cpu":  # the harness's own tests; the card is the default
        os.environ["AEFS_PLATFORM"] = "cpu"
    sock = _Socket()
    done = []  # (index, t_send, t_reply, reply)
    trace = None
    state = {}

    async def client():
        nonlocal trace
        await sock.inbox.put(json.dumps({"command": "build_chain", "config": cfg["chain"]}))
        i = 0
        for _ in range(tr["warmup_uploads"]):
            await sock.upload(url(i))
            i += 1
        gc.collect()
        t_w = time.perf_counter()
        state["setup_s"] = t_w - ctx.started
        state["t_w"] = t_w
        state["first"] = len(renders)
        while time.perf_counter() < t_w + ctx.seconds:
            done.append((i, *await sock.upload(url(i))))
            i += 1
        if torch.cuda.is_available() and ctx.device == "cuda":
            state["peak"] = torch.cuda.max_memory_allocated(torch.device(ctx.device))
        if ctx.trace:
            u = url(i)
            with tracing.profiler() as prof:
                tracing.mark(tracing.START)
                await sock.upload(u)
                if ctx.device == "cuda":
                    torch.cuda.synchronize()
                tracing.mark(tracing.END)
            trace = tracing.summarize(prof)
        await sock.inbox.put(None)

    async def main():
        gc.disable()  # as the backend serves (backend.main)
        try:
            await asyncio.gather(backend.handler(sock), client())
        finally:
            gc.enable()

    try:
        asyncio.run(main())
    finally:
        engine_mod.AudioEngine.process_file_array = original
    kind = torch.cuda.get_device_name() if ctx.device == "cuda" else "cpu"
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    t_w, t_end = state["t_w"], state["t_w"] + ctx.seconds
    in_window = [d for d in done if d[2] <= t_end]
    x_rt = (len(in_window) * frames / fs / (in_window[-1][2] - t_w)) if in_window else None
    failed, pcm_out = 0, {}
    for i, _ts, _tr, reply in done:
        try:
            pcm_out[i] = _check(reply, frames)
        except (ValueError, EOFError) as e:
            print(f"upload {i}: {e}", flush=True)
            failed += 1
    rng = np.random.default_rng(seed_of(ctx.seed, 5))
    pick = sorted(rng.choice([d[0] for d in in_window or done],
                             size=min(tr["compare_uploads"], len(in_window or done)),
                             replace=False).tolist()) if done else []
    worst, control = -np.inf, -np.inf
    for i in pick:
        mono = pcms[i].astype(np.float64).mean(axis=1) / 32768.0
        ref = np.clip(render_mono(mono, cfg["chain"], fs), -1.0, 1.0)
        if i not in pcm_out:
            worst = np.inf
        else:
            reply = next(d[3] for d in done if d[0] == i)
            plot = np.asarray(json.loads(reply)["processed_samples"])
            worst = max(worst, _gap(pcm_out[i].T.astype(np.float64) / 32767.0, plot, ref))
        if ctx.control:  # the control's audio in the program's place
            control = max(control, _gap(*_as_reply(
                render_mono(mono, cfg["chain"], fs, ctx.control)), ref))
    reply_s = [d[2] - d[1] for d in done]
    render_s = renders[state["first"]: state["first"] + len(done)]
    return Outcome(
        setup_s=state["setup_s"],
        attempted=len(done),
        failed=failed,
        e2e={"upload_x_realtime": x_rt},
        obs={"spans": {"reply_s": reply_s, "render_s": render_s},
             "counters": {"uploads": len(done), "uploads_in_window": len(in_window)},
             "trace": trace,
             "shapes": {"frames": frames, "fs": fs, "superblock": tr["superblock"],
                        "reverb": next((e.get("params", {}) for e in cfg["chain"]
                                        if e["type"] == "reverb"), None)}},
        checks={"err_dbfs": worst if pick else np.inf},
        control_checks={"err_dbfs": control} if ctx.control else {},
        memory_peak_bytes=state.get("peak", 0), device_kind=kind, device_count=1,
        notes={"uploads": len(done), "in_window": len(in_window), "compared": pick,
               "reply_s": {q: pct(reply_s, q) for q in (10, 50, 90)},
               "render_s": {q: pct(render_s, q) for q in (10, 50, 90)}},
    )
