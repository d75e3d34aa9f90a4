"""WebSocket serving layer (port of aefs_tpu/server/backend.py), wire-
compatible with the reference backend (src/backend.py) and the JAX
package's (docs/PROTOCOL.md): the same JSON commands

    {"command": "start_mic" | "stop" | "build_chain" | "update_param"
               | "process_file", ...}

plus the additive ones (``sync_delay_bpm``, ``sync_lfo_bpm``,
``reprocess_file``, ``stream_file``, ``list_devices``, ``set_devices``,
``set_ir``, ``learn_noise``, ``save_session``, ``resume_session``,
``get_stats``), and the same responses ({"type": "plot_data", ...} at
~30 FPS, {"type": "file_processed", ...}, ...).  Single client at a time
(backend.py:73-75), 500 MB max message (backend.py:128), GC disabled while
serving (backend.py:123).

The engine (``AudioEngine``) runs on the device ``select_device()`` names:
``AEFS_PLATFORM``, else the card, with no fallback.  The plot pump attaches
``PlotAnalyzer``'s STFT spectra and chroma, computed on that device.

Run: ``python -m aefs_tpu_torch.server.backend`` (``PORT``, default 8765).
"""

from __future__ import annotations

import asyncio
import functools
import gc
import json
import os
import queue

import numpy as np

from aefs_tpu_torch.core.config import PLOT_FPS, PLOT_QUEUE_BLOCKS, WS_MAX_MESSAGE
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.utils.metrics import TRACER
from aefs_tpu_torch.utils.platform import select_device

try:
    import websockets as ws
except ImportError:  # the handler itself does not need the package
    ws = None

connected_client = None
SEND_ANALYSIS = os.environ.get("AEFS_SERVER_ANALYSIS", "1") == "1"
# Reference wishlist todo:3 "stereo plots": also ship the right channel.
STEREO_PLOTS = os.environ.get("AEFS_STEREO_PLOTS", "0") == "1"


def _session_path(requested) -> str:
    """Confine client-supplied checkpoint names to AEFS_SESSIONS_DIR.

    The server listens unauthenticated (0.0.0.0): a raw filesystem path from
    the wire would let whichever host claims the single client slot write
    checkpoint data at any writable path and read back any checkpoint-shaped
    file.  ``path`` in the protocol is therefore a NAME (or relative
    subpath) under the sessions directory; absolute paths and ``..``
    escapes are rejected."""
    base = os.path.abspath(os.environ.get("AEFS_SESSIONS_DIR", ".aefs_sessions"))
    name = str(requested) if requested else "session"
    if os.path.isabs(name):
        raise ValueError(
            "session path must be a name under AEFS_SESSIONS_DIR, "
            f"not an absolute path: {name!r}")
    p = os.path.abspath(os.path.join(base, name))
    if p != base and not p.startswith(base + os.sep):
        raise ValueError(f"session path escapes AEFS_SESSIONS_DIR: {name!r}")
    return p


def serialize_audio_data(in_frames, out_frames, sample_rate, analysis=None,
                         stereo_in=False):
    """Concatenate queued blocks and serialize the plot payload: CPU-heavy,
    runs in an executor off the event loop (backend.py:15-29, :49-58).  The
    float lists use the port's serializer (``engine/jsonfmt.py``)."""
    from aefs_tpu_torch.engine import jsonfmt

    # Accept pre-concatenated arrays (the analyzer path already paid for the
    # concatenate).
    in_chunk = in_frames if isinstance(in_frames, np.ndarray) else np.concatenate(in_frames)
    out_chunk = out_frames if isinstance(out_frames, np.ndarray) else np.concatenate(out_frames)
    head = {"type": "plot_data", "sample_rate": sample_rate}
    if analysis is not None:
        head["analysis"] = analysis
    head_json = json.dumps(head)
    extra = ""
    if STEREO_PLOTS and out_chunk.shape[1] > 1:
        # input_r only when the capture is genuinely stereo: mono input is
        # fanned to two identical columns before the tap.
        if stereo_in and in_chunk.shape[1] > 1:
            extra += ',"input_r":' + jsonfmt.json_f32_array(in_chunk[:, 1])
        extra += ',"output_r":' + jsonfmt.json_f32_array(out_chunk[:, 1])
    return (
        head_json[:-1]
        + ',"input":' + jsonfmt.json_f32_array(in_chunk[:, 0])
        + ',"output":' + jsonfmt.json_f32_array(out_chunk[:, 0])
        + extra
        + "}"
    )


async def data_sender(websocket, data_queues, audio_engine, analyzer=None):
    """~30 FPS pump draining the plot queues (backend.py:32-67)."""
    from aefs_tpu_torch.core.config import CHANNELS_IN

    loop = asyncio.get_running_loop()

    def drain_and_serialize():
        """Runs in the executor: drain matched in/out block pairs (the two
        puts of a block are not atomic, so only pairs are taken; a stray
        block waits for its partner next tick), then analyze and serialize
        off the event loop (the analysis runs device FFTs and reads them
        back)."""
        in_frames, out_frames = [], []
        while not data_queues["input"].empty() and not data_queues["output"].empty():
            try:
                in_frames.append(data_queues["input"].get_nowait())
                out_frames.append(data_queues["output"].get_nowait())
            except queue.Empty:
                break
        if not in_frames or not out_frames:
            return None
        n = min(len(in_frames), len(out_frames))
        in_chunk = np.concatenate(in_frames[:n])
        out_chunk = np.concatenate(out_frames[:n])
        analysis = None
        if analyzer is not None:
            try:
                if analyzer.fs != audio_engine.current_sample_rate:
                    # Sample-rate renegotiation: rebuild the analysis maps.
                    analyzer.__init__(audio_engine.current_sample_rate, device=analyzer.device)
                analysis = analyzer.update(in_chunk[:, 0], out_chunk[:, 0])
            except Exception as e:  # the plots go on without the analysis
                print(f"Warning: plot analysis failed: {e}")
                analysis = None
        return serialize_audio_data(in_chunk, out_chunk, audio_engine.current_sample_rate,
                                    analysis, CHANNELS_IN > 1)

    while True:
        try:
            payload = await loop.run_in_executor(None, drain_and_serialize)
            if payload is not None:
                await websocket.send(payload)
            await asyncio.sleep(1.0 / PLOT_FPS)
        except Exception:  # the client went away: the pump ends
            break


async def audio_streamer(websocket, audio_engine):
    """Pump for the live file stream (reference wishlist todo:4): drains the
    engine's lossless playback queue and ships processed stereo blocks as
    ``stream_audio`` messages, batching whatever accumulated each tick into
    one message.  Ends with ``{"type": "stream_audio_end"}`` when the file
    runs out (the engine enqueues a ``None`` sentinel) or the stream is
    stopped."""
    from aefs_tpu_torch.engine import jsonfmt

    loop = asyncio.get_running_loop()
    q = audio_engine.playback_queue

    def drain():
        try:
            first = q.get(timeout=0.25)
        except queue.Empty:
            return [], False
        if first is None:
            return [], True
        blocks, done = [first], False
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                done = True
                break
            blocks.append(item)
        return blocks, done

    try:
        while True:
            blocks, done = await loop.run_in_executor(None, drain)
            if blocks:
                chunk = np.concatenate([b for _, b in blocks])
                head = json.dumps({
                    "type": "stream_audio",
                    "seq": int(blocks[0][0]),
                    "sample_rate": audio_engine.current_sample_rate,
                })
                await websocket.send(
                    head[:-1]
                    + ',"left":' + jsonfmt.json_f32_array(chunk[:, 0])
                    + ',"right":' + jsonfmt.json_f32_array(chunk[:, min(1, chunk.shape[1] - 1)])
                    + "}")
            if done:
                await websocket.send(json.dumps({"type": "stream_audio_end"}))
                return
    except Exception:  # the client went away: the pump ends
        pass


def _make_plot_queue():
    """The audio -> sender plot handoff: the native SPSC ring, or a
    ``queue.Queue`` where the C++ library cannot build (the JAX backend's
    rule; host plumbing, not the device)."""
    from aefs_tpu_torch.core.config import BLOCKSIZE, CHANNELS_OUT

    try:
        from aefs_tpu_torch import native

        return native.BlockQueue((BLOCKSIZE, CHANNELS_OUT), PLOT_QUEUE_BLOCKS)
    except Exception:
        return queue.Queue(maxsize=PLOT_QUEUE_BLOCKS)


async def handler(websocket):
    global connected_client
    if connected_client is not None:
        print("Warning: client already connected. Rejecting new connection")
        return

    connected_client = websocket
    print("Connected to frontend client")
    # Everything after the client-slot claim sits under try/finally: the
    # engine build picks the device (which raises without a card unless
    # the CPU is asked for), and an exception here must not leave
    # connected_client set, rejecting every future connection.  The build
    # runs in the executor so it never freezes the event loop.
    audio_engine = None
    sender_task = None
    try:
        data_queues = {"input": _make_plot_queue(), "output": _make_plot_queue()}
        loop = asyncio.get_running_loop()
        device = select_device()
        audio_engine = await loop.run_in_executor(
            None, functools.partial(AudioEngine, data_queues, device=device))

        analyzer = None
        if SEND_ANALYSIS:
            from aefs_tpu_torch.utils.analysis import PlotAnalyzer

            analyzer = PlotAnalyzer(audio_engine.current_sample_rate, device=device)

        sender_task = asyncio.create_task(
            data_sender(websocket, data_queues, audio_engine, analyzer))
        file_tasks = set()  # process_file and stream pumps, held until they end

        def spawn(coro):
            task = asyncio.create_task(coro)
            file_tasks.add(task)
            task.add_done_callback(file_tasks.discard)

        async for message in websocket:
            taken = TRACER.clock()  # an upload's front.upload span starts here
            try:
                cmd = json.loads(message)
                command = cmd.get("command")
                if command == "start_mic":
                    audio_engine.start_mic_stream()
                elif command == "stop":
                    # Executor: stop_stream joins the file-stream thread (up
                    # to 30 s if a step is wedged); inline it would stall
                    # keepalive pings and every other command.
                    await loop.run_in_executor(None, audio_engine.stop_stream)
                elif command == "build_chain":
                    # A build warms the chain on the device: off the loop.
                    await loop.run_in_executor(
                        None, audio_engine.build_chain, cmd.get("config", []))
                elif command == "update_param":
                    audio_engine.update_param(
                        cmd.get("effect_id"), cmd.get("param"), cmd.get("value"))
                elif command == "sync_delay_bpm":
                    # Set a delay's time from a tempo and note division.
                    # ``param`` defaults to delay_ms but may name a
                    # parallel-branch lifted param like b0_1_delay_ms.
                    from aefs_tpu_torch.utils.tempo import delay_ms_for

                    ms = delay_ms_for(cmd.get("bpm", 120), cmd.get("division", 1.0))
                    if ms > 1499.0:
                        print(f"Warning: BPM-synced delay {ms:.0f} ms exceeds the "
                              "1499 ms delay ceiling; clamping loses tempo sync")
                    audio_engine.update_param(
                        cmd.get("effect_id"), cmd.get("param", "delay_ms"), ms)
                elif command == "sync_lfo_bpm":
                    # One LFO cycle per ``division`` beats (the modulation
                    # family's rate_hz; unknown params warn in update_param).
                    from aefs_tpu_torch.utils.tempo import lfo_rate_hz_for

                    hz = lfo_rate_hz_for(cmd.get("bpm", 120), cmd.get("division", 1.0))
                    audio_engine.update_param(
                        cmd.get("effect_id"), cmd.get("param", "rate_hz"), hz)
                elif command == "process_file":
                    spawn(audio_engine.process_wav_file(cmd.get("contents"), websocket, taken))
                elif command == "reprocess_file":
                    # Re-run the LAST uploaded file through the CURRENT chain
                    # without re-shipping the payload.
                    if audio_engine.last_file_contents is None:
                        print("Warning: no file uploaded yet; nothing to reprocess")
                    else:
                        spawn(audio_engine.process_wav_file(
                            audio_engine.last_file_contents, websocket, taken))
                elif command == "stream_file":
                    # Play the uploaded file through the LIVE path so param
                    # changes apply while it plays.  Decode and a possible
                    # rebuild run in the executor; once the engine's source
                    # thread is up, attach the playback pump.
                    started = await loop.run_in_executor(
                        None, lambda: audio_engine.start_file_stream(
                            cmd.get("contents"), realtime=cmd.get("realtime", True)))
                    # Tell the client either way BEFORE attaching the pump,
                    # so stream_started precedes any stream_audio: a refusal
                    # produces no stream_audio_end.
                    await websocket.send(json.dumps({"type": "stream_started",
                                                     "ok": bool(started)}))
                    if started:
                        spawn(audio_streamer(websocket, audio_engine))
                elif command == "list_devices":
                    # PortAudio devices; [] in server mode.
                    from aefs_tpu_torch.engine.devices import list_devices

                    await websocket.send(json.dumps({
                        "type": "devices",
                        "devices": list_devices(),
                        "selected": list(audio_engine.devices),
                    }))
                elif command == "set_devices":
                    # Executor: may restart a running mic stream.
                    await loop.run_in_executor(
                        None, audio_engine.set_devices, cmd.get("input"), cmd.get("output"))
                elif command == "set_ir":
                    # A user-uploaded convreverb IR (WAV data URL); the
                    # rebuild runs in the executor.
                    eid = cmd.get("effect_id")
                    try:
                        seconds = await loop.run_in_executor(
                            None, audio_engine.set_ir, eid, cmd.get("contents"))
                        await websocket.send(json.dumps({
                            "type": "ir_set", "effect_id": eid, "ok": True,
                            "ir_seconds": round(seconds, 3)}))
                    except Exception as e:
                        print(f"Error setting IR: {e}")
                        await websocket.send(json.dumps({
                            "type": "ir_set", "effect_id": eid, "ok": False, "error": str(e)}))
                elif command == "learn_noise":
                    # A per-bin noise profile for a spectral filter, from an
                    # uploaded noise WAV or a live capture of the next N
                    # seconds of streaming input.  Executor: the capture
                    # waits for blocks and the rebuild warms the chain.
                    eid = cmd.get("effect_id")
                    try:
                        # Clamp the client's capture length: an absurd value
                        # would pin an executor thread and grow the capture.
                        seconds = min(30.0, max(0.1, float(cmd.get("seconds", 2.0))))
                        floor_db = await loop.run_in_executor(
                            None, audio_engine.learn_noise, eid, cmd.get("contents"), seconds)
                        await websocket.send(json.dumps({
                            "type": "noise_learned", "effect_id": eid, "ok": True,
                            "floor_db": round(floor_db, 1)}))
                    except Exception as e:
                        print(f"Error learning noise profile: {e}")
                        await websocket.send(json.dumps({
                            "type": "noise_learned", "effect_id": eid, "ok": False,
                            "error": str(e)}))
                elif command == "save_session":
                    # A durable server-side checkpoint (chain config, targets,
                    # audio state) under AEFS_SESSIONS_DIR.
                    raw_path = cmd.get("path")
                    path = None
                    try:
                        path = _session_path(raw_path)
                        await loop.run_in_executor(None, audio_engine.save_session, path)
                        await websocket.send(json.dumps(
                            {"type": "session_saved", "ok": True, "path": path}))
                    except Exception as e:
                        # The client must learn about the failure too.
                        print(f"Error saving session: {e}")
                        await websocket.send(json.dumps(
                            {"type": "session_saved", "ok": False,
                             "path": path or str(raw_path), "error": str(e)}))
                elif command == "resume_session":
                    raw_path = cmd.get("path")
                    path = None
                    try:
                        path = _session_path(raw_path)
                        cfg = await loop.run_in_executor(None, audio_engine.resume_session, path)
                        # Echo the restored config so the UI syncs its chain.
                        await websocket.send(json.dumps(
                            {"type": "session_resumed", "ok": True, "path": path,
                             "config": cfg}))
                    except Exception as e:
                        print(f"Error resuming session: {e}")
                        await websocket.send(json.dumps(
                            {"type": "session_resumed", "ok": False,
                             "path": path or str(raw_path), "error": str(e)}))
                elif command == "get_stats":
                    # Operational metrics: per-block p50/p99 and deadline
                    # misses (the xrun counter the reference never surfaced,
                    # engine.py:157-158).
                    stats = {
                        "type": "stats",
                        "engine": audio_engine.metrics.snapshot(),
                        "is_running": audio_engine.is_running,
                        "sample_rate": audio_engine.current_sample_rate,
                        # drop counters of the native SPSC plot rings
                        "plot_drops": {k: getattr(q, "dropped", 0)
                                       for k, q in data_queues.items()},
                    }
                    if TRACER.enabled:  # AEFS_TRACE=1: the program's spans
                        stats["trace"] = TRACER.snapshot()
                    await websocket.send(json.dumps(stats))
            except json.JSONDecodeError:
                print(f"Error: message is not valid JSON: {message}")
            except Exception as e:  # a failed command is reported, the session goes on
                print(f"Error processing command: {e}")
    finally:
        # Free the single-client slot FIRST and unconditionally: an exception
        # from the engine teardown below must never leave a dead websocket
        # registered, rejecting every future client.
        connected_client = None
        if sender_task is not None:
            sender_task.cancel()
        # close() stops the streams (the port's stop_stream ordering: the
        # stop event is published with its thread) and drops the chain; it
        # can block up to 30 s joining a wedged file-stream thread, so it
        # runs on the executor.  The engine may not exist if its build
        # failed.
        if audio_engine is not None:
            try:
                await asyncio.get_running_loop().run_in_executor(None, audio_engine.close)
            except Exception as e:
                print(f"Error closing engine on disconnect: {e}")
        print("Disconnected from frontend client")


async def main():
    gc.disable()  # GC pauses would glitch the audio path (backend.py:123)
    if ws is None:
        raise RuntimeError("the backend needs the websockets package, which is not installed")
    device = select_device()
    port = int(os.environ.get("PORT", 8765))
    print(f"Audio effects server initialized on port {port} (device: {device})", flush=True)
    async with ws.serve(handler, "0.0.0.0", port, max_size=WS_MAX_MESSAGE):
        await asyncio.Future()


if __name__ == "__main__":
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        print("\nClosing server")
        gc.enable()
