"""The serving front of the PyTorch port against the JAX package's on the
CPU: the WebSocket backend (aefs_tpu_torch/server/backend.py), the UI
server (ui/app.py) and the launcher (run.py).

Each WebSocket case is the counterpart of one of tests/test_server.py's:
JAX's and the port's ``handler`` each serve on 127.0.0.1:0 and get the same
scripted client.  Their replies must come in the same order (``plot_data``
aside); ``file_processed`` audio is within -90 dBFS of JAX's (the JSON
carries 5 significant digits) and its WAV within one 16-bit step.  Beyond
those: ``_session_path``'s errors equal JAX's, a session saved through one
backend resumes through the other (both ways), ``stream_file`` over the
wire equals the engine's file stream, the backend refuses to start without
a card unless asked for the CPU, the UI server serves the SPA by path with
JAX's ``/config.json``, and the launcher starts both children, installs
nothing, and leaves no child after SIGTERM.
"""

import asyncio
import base64
import gc
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from aefs_tpu.engine.wavio import decode_wav, encode_wav_int16
from aefs_tpu.server import backend as jax_backend
from aefs_tpu_torch.server import backend

from oracles import err_dbfs

ws = pytest.importorskip("websockets")

FS = 48000
ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP16 = 1.0 / 32768.0  # one 16-bit step
FILTER = [{"effect_id": "f1", "type": "filter",
           "params": {"filter_type": 0, "cutoff_hz": 1200, "q": 0.707}}]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """The port's handler picks its device per connection: here the CPU."""
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _url(x, fs=FS):
    return "data:audio/wav;base64," + base64.b64encode(encode_wav_int16(x, fs)).decode()


async def _recv(client, kind, seen, timeout=120):
    """Receive until a message of type ``kind``; every message lands in
    ``seen``."""
    for _ in range(400):
        msg = json.loads(await asyncio.wait_for(client.recv(), timeout))
        seen.append(msg)
        if msg["type"] == kind:
            return msg
    raise AssertionError(f"no {kind} reply")


async def _serve(module, script, tag):
    """``script(client, tag, seen, port)`` against one backend's handler on
    its own server; returns (result, seen)."""
    server = await ws.serve(module.handler, "127.0.0.1", 0, max_size=2**29)
    port = server.sockets[0].getsockname()[1]
    seen = []
    try:
        async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**29) as client:
            return await script(client, tag, seen, port), seen
    finally:
        server.close()
        await server.wait_closed()


def _serve_both(script):
    """The same scripted client against JAX's and the port's handler at
    once; returns {"jax": (result, seen), "port": (result, seen)}."""
    async def both():
        return await asyncio.gather(_serve(jax_backend, script, "jax"),
                                    _serve(backend, script, "port"))

    jax_out, port_out = asyncio.run(both())
    assert backend.connected_client is None and jax_backend.connected_client is None
    return {"jax": jax_out, "port": port_out}


def _kinds(seen):
    return [m["type"] for m in seen if m["type"] != "plot_data"]


def _same_kinds(out):
    assert _kinds(out["jax"][1]) == _kinds(out["port"][1]), (_kinds(out["jax"][1]),
                                                            _kinds(out["port"][1]))


def _processed(msg):
    """(processed_samples, the decoded processed WAV) of a file_processed."""
    audio, fs = decode_wav(base64.b64decode(msg["processed_b64"].split(",")[1]))
    return np.asarray(msg["processed_samples"]), audio, fs


def _assert_files_close(jmsg, pmsg):
    js, jwav, jfs = _processed(jmsg)
    ps, pwav, pfs = _processed(pmsg)
    assert jfs == pfs and jwav.shape == pwav.shape
    assert err_dbfs(ps, js) <= -90, err_dbfs(ps, js)
    assert np.max(np.abs(pwav - jwav)) <= STEP16 + 1e-9
    assert pmsg["original_samples"] == jmsg["original_samples"]
    for k in ("original", "processed"):
        assert (len(pmsg["analysis"][k]["spectrum_db"])
                == len(jmsg["analysis"][k]["spectrum_db"]))


def test_ws_protocol_round_trip():
    """build_chain, update_param (a wrong id first), bad JSON, process_file
    and get_stats, then a second client is refused: the same replies from
    both backends, the file within -90 dBFS / one 16-bit step of JAX's."""
    t = np.arange(FS) / FS
    sig = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "build_chain", "config": FILTER}))
        for eid in ("nope", "f1"):
            await client.send(json.dumps({"command": "update_param", "effect_id": eid,
                                          "param": "cutoff_hz", "value": 500}))
        await client.send("this is not json")
        await client.send(json.dumps({"command": "process_file", "contents": _url(sig[:, None])}))
        msg = await _recv(client, "file_processed", seen)
        await client.send(json.dumps({"command": "get_stats"}))
        stats = await _recv(client, "stats", seen)
        async with ws.connect(f"ws://127.0.0.1:{port}") as c2:
            try:
                await asyncio.wait_for(c2.recv(), 3)
            except ws.exceptions.ConnectionClosedOK:  # closed without a reply: refused
                return msg, stats, "refused"
        return msg, stats, "answered"

    out = _serve_both(script)
    _same_kinds(out)
    (jmsg, jstats, jsecond), _ = out["jax"]
    (pmsg, pstats, psecond), _ = out["port"]
    assert psecond == jsecond == "refused"
    _assert_files_close(jmsg, pmsg)
    _, audio, _ = _processed(pmsg)
    assert 0.1 < float(np.sqrt(np.mean(audio[:, 0] ** 2))) < 0.4
    assert pstats["sample_rate"] == jstats["sample_rate"] == FS
    assert set(pstats["engine"]) == set(jstats["engine"]) and "xruns" in pstats["engine"]
    assert set(pstats) == set(jstats)


def test_ws_session_checkpoint_and_bpm_sync(tmp_path, monkeypatch):
    """save_session / resume_session with BPM-synced targets, a missing
    session and the rejected absolute and ``..`` paths: the same replies and
    errors from both backends; the synced targets survive the checkpoint."""
    monkeypatch.setenv("AEFS_SESSIONS_DIR", str(tmp_path))
    cfg = [{"effect_id": "d1", "type": "delay",
            "params": {"delay_ms": 200, "feedback": 0.3, "mix_dry": 1.0, "mix_wet": 0.8,
                       "offset_ms": 0}},
           {"effect_id": "t1", "type": "tremolo",
            "params": {"rate_hz": 5.0, "depth": 0.5, "spread": 0.0}}]

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "build_chain", "config": cfg}))
        await client.send(json.dumps({"command": "sync_delay_bpm", "effect_id": "d1",
                                      "bpm": 120, "division": 1.0}))
        await client.send(json.dumps({"command": "sync_lfo_bpm", "effect_id": "t1",
                                      "bpm": 120, "division": 1.0}))
        await client.send(json.dumps({"command": "save_session", "path": f"sess_{tag}"}))
        saved = await _recv(client, "session_saved", seen)
        await client.send(json.dumps({"command": "resume_session", "path": f"sess_{tag}"}))
        resumed = await _recv(client, "session_resumed", seen)
        await client.send(json.dumps({"command": "resume_session", "path": "no"}))
        missing = await _recv(client, "session_resumed", seen)
        bad = []
        for path in ("/etc/passwd_dir", "../outside"):
            await client.send(json.dumps({"command": "save_session", "path": path}))
            bad.append(await _recv(client, "session_saved", seen))
        await client.send(json.dumps({"command": "get_stats"}))
        await _recv(client, "stats", seen)
        return saved, resumed, missing, bad

    out = _serve_both(script)
    _same_kinds(out)
    for tag in ("jax", "port"):
        saved, resumed, missing, bad = out[tag][0]
        assert saved["ok"] and saved["path"] == str(tmp_path / f"sess_{tag}")
        assert resumed["ok"] and resumed["config"][0]["effect_id"] == "d1"
        assert missing["ok"] is False and missing.get("error")
        saved_json = json.loads((tmp_path / f"sess_{tag}" / "session.json").read_text())
        assert saved_json["targets"]["d1"]["delay_ms"] == 500.0
        assert saved_json["targets"]["t1"]["rate_hz"] == 2.0
    assert [m["error"] for m in out["port"][0][3]] == [m["error"] for m in out["jax"][0][3]]
    assert all(not m["ok"] and "AEFS_SESSIONS_DIR" in m["error"] for m in out["port"][0][3])


@pytest.mark.parametrize("name", ["", "a", "a/b", "a/../b", "/abs/x", "../up", "a/../../up"])
def test_session_path_matches_jax(name, tmp_path, monkeypatch):
    """``_session_path``: the same paths, and the same errors for absolute
    paths and ``..`` escapes."""
    monkeypatch.setenv("AEFS_SESSIONS_DIR", str(tmp_path))
    try:
        want = jax_backend._session_path(name)
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            backend._session_path(name)
        assert str(info.value) == str(e)
    else:
        assert backend._session_path(name) == want


async def _stream(client, url, seen):
    """stream_file (realtime false) of ``url``: the streamed (N, 2) audio."""
    await client.send(json.dumps({"command": "stream_file", "contents": url, "realtime": False}))
    start = len(seen)
    await _recv(client, "stream_audio_end", seen)
    msgs = [m for m in seen[start:] if m["type"] == "stream_audio"]
    return np.stack([np.concatenate([m["left"] for m in msgs]),
                     np.concatenate([m["right"] for m in msgs])], 1)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ws_session_crosses_packages(direction, tmp_path, monkeypatch):
    """A session saved through one package's backend (after a stream filled
    its delay line, with a live target changed) resumes through the
    other's: the next stream continues within -90 dBFS of the saving
    backend's own continuation after its resume."""
    monkeypatch.setenv("AEFS_SESSIONS_DIR", str(tmp_path))
    cfg = [{"effect_id": "d1", "type": "delay",
            "params": {"delay_ms": 120, "feedback": 0.4, "mix_dry": 1.0, "mix_wet": 0.7,
                       "offset_ms": 0}},
           {"effect_id": "f1", "type": "filter",
            "params": {"filter_type": 0, "cutoff_hz": 3000, "q": 0.707}}]
    rng = np.random.default_rng(2)
    fill, cont = ((0.1 * rng.standard_normal((n * 256, 1))).astype(np.float32)
                  for n in (30, 12))
    first, second = ((jax_backend, backend) if direction == "jax_to_port"
                     else (backend, jax_backend))

    async def script(client, tag, seen, port):
        if tag == "saver":
            await client.send(json.dumps({"command": "build_chain", "config": cfg}))
            await client.send(json.dumps({"command": "update_param", "effect_id": "f1",
                                          "param": "cutoff_hz", "value": 900}))
            await _stream(client, _url(fill), seen)
            await client.send(json.dumps({"command": "save_session", "path": "x"}))
            assert (await _recv(client, "session_saved", seen))["ok"]
        await client.send(json.dumps({"command": "resume_session", "path": "x"}))
        resumed = await _recv(client, "session_resumed", seen)
        assert resumed["ok"], resumed
        assert [c["effect_id"] for c in resumed["config"]] == ["d1", "f1"]
        assert resumed["config"][1]["params"]["cutoff_hz"] == 900
        return await _stream(client, _url(cont), seen)

    want, _ = asyncio.run(_serve(first, script, "saver"))
    got, _ = asyncio.run(_serve(second, script, "resumer"))
    assert got.shape == want.shape == (12 * 256, 2)
    assert np.max(np.abs(want)) > 0.01
    assert err_dbfs(got, want) <= -90, err_dbfs(got, want)


def test_ws_file_reentrancy_guard():
    """A second process_file while a job is active is ignored: one
    file_processed for two back-to-back uploads, from both backends."""
    sig = (0.2 * np.sin(2 * np.pi * 330 * np.arange(FS) / FS)).astype(np.float32)

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "build_chain", "config": []}))
        for _ in range(2):
            await client.send(json.dumps({"command": "process_file",
                                          "contents": _url(sig[:, None])}))
        msg = await _recv(client, "file_processed", seen)
        try:  # a second job would answer within this window
            while True:
                seen.append(json.loads(await asyncio.wait_for(client.recv(), 2)))
        except asyncio.TimeoutError:
            pass
        return msg

    out = _serve_both(script)
    _same_kinds(out)
    assert _kinds(out["port"][1]).count("file_processed") == 1
    _assert_files_close(out["jax"][0], out["port"][0])


def test_stereo_plot_serialization_fields(monkeypatch):
    """serialize_audio_data, stereo plots on and off: the payload JAX's
    backend writes, byte for byte."""
    blocks = [np.stack([np.arange(4, dtype=np.float32),
                        np.arange(4, dtype=np.float32) + 10], axis=1)]
    for stereo in (True, False):
        monkeypatch.setattr(backend, "STEREO_PLOTS", stereo)
        monkeypatch.setattr(jax_backend, "STEREO_PLOTS", stereo)
        for analysis in (None, {"x": [1.5]}):
            got = backend.serialize_audio_data(blocks, blocks, FS, analysis, stereo_in=True)
            assert got == jax_backend.serialize_audio_data(blocks, blocks, FS, analysis,
                                                           stereo_in=True)
    payload = json.loads(backend.serialize_audio_data(blocks, blocks, FS, stereo_in=True))
    assert payload["input"] == [0, 1, 2, 3] and "input_r" not in payload


def test_ws_malformed_uploads_do_not_kill_the_server():
    """Junk process_file payloads leave both backends alive: a stats request
    still answers, and no file_processed is sent."""
    junk = ["no comma here", "data:audio/wav;base64,!!!not-base64!!!",
            "data:audio/wav;base64," + base64.b64encode(b"definitely not a wav").decode(),
            "data:audio/wav;base64," + base64.b64encode(b"RIFF\x04\x00\x00\x00WAVE").decode()]

    async def script(client, tag, seen, port):
        for contents in junk:
            await client.send(json.dumps({"command": "process_file", "contents": contents}))
        await client.send(json.dumps({"command": "get_stats"}))
        return await _recv(client, "stats", seen)

    out = _serve_both(script)
    _same_kinds(out)
    assert _kinds(out["port"][1]) == ["stats"]


def test_ws_set_ir_round_trip():
    """An uploaded IR (a delayed impulse of 0.5 at 1000 samples) turns the
    convreverb into a scaled delay in both backends; a bad effect id
    answers ir_set ok=false."""
    lag = 1000
    ir = np.zeros(4000, np.float32)
    ir[lag] = 0.5
    sig = (0.1 * np.random.default_rng(0).standard_normal(FS)).astype(np.float32)
    cfg = [{"effect_id": "cv", "type": "convreverb",
            "params": {"mix_dry": 0.0, "mix_wet": 1.0, "ir_seconds": 0.1}}]

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "build_chain", "config": cfg}))
        replies = []
        for eid in ("nope", "cv"):
            await client.send(json.dumps({"command": "set_ir", "effect_id": eid,
                                          "contents": _url(ir[:, None])}))
            replies.append(await _recv(client, "ir_set", seen))
        await client.send(json.dumps({"command": "process_file", "contents": _url(sig[:, None])}))
        return replies, await _recv(client, "file_processed", seen, timeout=180)

    out = _serve_both(script)
    _same_kinds(out)
    (jbad, jok), jmsg = out["jax"][0]
    (pbad, pok), pmsg = out["port"][0]
    assert not pbad["ok"] and not jbad["ok"]
    assert pok["ok"] and pok["ir_seconds"] == jok["ir_seconds"] == pytest.approx(4000 / FS, abs=1e-3)
    _assert_files_close(jmsg, pmsg)
    ref = np.zeros(FS)
    ref[lag:] = 0.5 * sig[:-lag]
    assert np.max(np.abs(np.asarray(pmsg["processed_samples"]) - ref)) < 5e-3


def _http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def test_ui_http_server_serves_spa_and_config():
    """The port's UI server over real HTTP: / is index.html, /config.json
    equals JAX's payload, and every asset is served by path from the
    repository's aefs_tpu/ui/assets/, byte for byte."""
    from aefs_tpu.ui.app import config_payload as jax_payload
    from aefs_tpu_torch.ui.app import serve

    assets = ROOT / "aefs_tpu" / "ui" / "assets"
    httpd = serve(port=0, blocking=False)
    port = httpd.server_address[1]
    try:
        status, body = _http_get(port, "/")
        assert status == 200 and body == (assets / "index.html").read_bytes()
        status, body = _http_get(port, "/config.json")
        assert status == 200
        assert json.loads(body) == json.loads(json.dumps(jax_payload()))
        assert json.loads(body)["static_params"] == {"convreverb": ["ir_seconds"],
                                                     "limiter": ["lookahead_ms"]}
        for f in sorted(assets.iterdir()):
            status, body = _http_get(port, f"/{f.name}")
            assert status == 200 and body == f.read_bytes(), f.name
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_spa_serves_session_and_interaction_surfaces():
    """The SPA the port serves is the JAX package's, with the session,
    IR-upload, reprocess and file-stream surfaces the protocol needs; no
    asset is copied into the port."""
    from aefs_tpu_torch.ui.app import ASSETS_DIR

    assets = pathlib.Path(ASSETS_DIR)
    assert assets.resolve() == (ROOT / "aefs_tpu" / "ui" / "assets").resolve()
    html = (assets / "index.html").read_text()
    appjs = (assets / "app.js").read_text()
    assert 'id="save-session"' in html and 'id="resume-session"' in html
    for cmd in ("save_session", "resume_session", "set_ir", "reprocess_file", "stream_file"):
        assert cmd in appjs, cmd
    assert 'id="stream-file"' in html and "onStreamAudio" in appjs


def test_ws_reprocess_file_uses_current_chain():
    """reprocess_file re-runs the last upload through the current chain (a
    no-op before any upload) in both backends: the 200 Hz rebuild bites,
    and each render matches JAX's."""
    sig = (0.1 * np.random.default_rng(1).standard_normal(FS // 2)).astype(np.float32)

    def lowpass(hz):
        return [{"effect_id": "f", "type": "filter",
                 "params": {"filter_type": 0, "cutoff_hz": hz, "q": 0.707}}]

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "reprocess_file"}))
        await client.send(json.dumps({"command": "build_chain", "config": lowpass(8000)}))
        await client.send(json.dumps({"command": "process_file", "contents": _url(sig[:, None])}))
        first = await _recv(client, "file_processed", seen)
        await client.send(json.dumps({"command": "update_param", "effect_id": "f",
                                      "param": "cutoff_hz", "value": 200}))
        await client.send(json.dumps({"command": "build_chain", "config": lowpass(200)}))
        await client.send(json.dumps({"command": "reprocess_file"}))
        return first, await _recv(client, "file_processed", seen)

    out = _serve_both(script)
    _same_kinds(out)
    for jm, pm in zip(out["jax"][0], out["port"][0]):
        _assert_files_close(jm, pm)
    first, second = (np.asarray(m["processed_samples"]) for m in out["port"][0])
    assert np.sqrt(np.mean(second ** 2)) < 0.7 * np.sqrt(np.mean(first ** 2))


def test_ws_device_selection_surface():
    """list_devices answers an empty list (no sounddevice here) and
    set_devices stores the pair, in both backends."""
    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "list_devices"}))
        before = await _recv(client, "devices", seen)
        await client.send(json.dumps({"command": "set_devices", "input": 3, "output": 5}))
        await client.send(json.dumps({"command": "list_devices"}))
        return before, await _recv(client, "devices", seen)

    out = _serve_both(script)
    _same_kinds(out)
    assert out["port"][0] == out["jax"][0]
    before, after = out["port"][0]
    assert before["devices"] == [] and before["selected"] == [None, None]
    assert after["selected"] == [3, 5]


def test_list_devices_with_stubbed_hardware(monkeypatch):
    """The port's list_devices maps PortAudio rows to picker entries as
    JAX's does (stubbed sounddevice)."""
    from aefs_tpu.engine import devices as jax_devmod
    from aefs_tpu_torch.engine import devices as devmod

    class FakeSd:
        @staticmethod
        def query_devices():
            return [{"name": "USB Mic", "max_input_channels": 1, "max_output_channels": 0,
                     "hostapi": 0},
                    {"name": "Speakers", "max_input_channels": 0, "max_output_channels": 2,
                     "hostapi": 0}]

    monkeypatch.setattr(devmod, "sd", FakeSd)
    monkeypatch.setattr(jax_devmod, "sd", FakeSd)
    devs = devmod.list_devices()
    assert devs == jax_devmod.list_devices()
    assert [d["usable_input"] for d in devs] == [True, False]
    assert [d["usable_output"] for d in devs] == [False, True]


def test_ws_stream_file_matches_engine_stream():
    """stream_file (realtime false) through the port's backend:
    stream_started, stream_audio blocks, stream_audio_end, as from JAX's;
    the concatenated blocks equal the port engine's own file stream bit for
    bit (after the JSON's 5 digits) and JAX's within -90 dBFS; plot_data
    carries the analysis."""
    from aefs_tpu_torch.engine.engine import AudioEngine

    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.7}},
           {"effect_id": "d", "type": "delay",
            "params": {"delay_ms": 80, "feedback": 0.3, "mix_dry": 1.0, "mix_wet": 0.6,
                       "offset_ms": 0}}]
    sig = (0.2 * np.sin(2 * np.pi * 440 * np.arange(40 * 256) / FS)).astype(np.float32)
    url = _url(sig[:, None])

    async def script(client, tag, seen, port):
        await client.send(json.dumps({"command": "build_chain", "config": cfg}))
        await client.send(json.dumps({"command": "stream_file", "contents": url,
                                      "realtime": False}))
        await _recv(client, "stream_audio_end", seen)
        if not any(m["type"] == "plot_data" for m in seen):
            await _recv(client, "plot_data", seen, timeout=30)
        return [m for m in seen if m["type"] == "stream_audio"]

    out = _serve_both(script)
    # How many blocks a stream_audio message batches is the pump's timing.
    kinds = {tag: [k for i, k in enumerate(_kinds(seen))
                   if k != "stream_audio" or _kinds(seen)[i - 1] != "stream_audio"]
             for tag, (_, seen) in out.items()}
    assert kinds["port"] == kinds["jax"] == ["stream_started", "stream_audio",
                                             "stream_audio_end"]
    plots = [m for m in out["port"][1] if m["type"] == "plot_data"]
    assert plots and "spectrum_db" in json.dumps(plots[-1]["analysis"])

    def joined(msgs):
        return np.stack([np.concatenate([m["left"] for m in msgs]),
                         np.concatenate([m["right"] for m in msgs])], 1)

    got, want_jax = joined(out["port"][0]), joined(out["jax"][0])
    eng = AudioEngine(device="cpu")
    eng.build_chain(cfg)
    assert eng.start_file_stream(url, realtime=False)
    items = []
    while (item := eng.playback_queue.get(timeout=60)) is not None:
        items.append(item)
    eng.close()
    ref = np.concatenate([b for _, b in items])
    ref5 = np.asarray(json.loads(backend.serialize_audio_data(ref, ref, FS))["output"])
    assert got.shape == ref.shape and np.array_equal(got[:, 0], ref5)
    assert err_dbfs(got, want_jax) <= -90, err_dbfs(got, want_jax)


def test_backend_needs_a_card_unless_asked(monkeypatch):
    """Without ``AEFS_PLATFORM`` the backend runs on the card: with none it
    refuses the connection (the client slot is freed) and ``main`` raises
    before it serves.  No CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    monkeypatch.delenv("AEFS_PLATFORM")

    async def scenario():
        server = await ws.serve(backend.handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}") as client:
                with pytest.raises(ws.exceptions.ConnectionClosed):
                    await asyncio.wait_for(client.recv(), 30)
        finally:
            server.close()
            await server.wait_closed()

    asyncio.run(scenario())
    assert backend.connected_client is None
    try:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            asyncio.run(backend.main())
    finally:
        gc.enable()  # main() turns the collector off for serving


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, env_extra):
    """``python -m aefs_tpu_torch.run`` on free ports, with a ``pip`` on
    PYTHONPATH that records any call; returns (proc, backend, ui ports,
    marker path)."""
    fake = tmp_path / "fakepip" / "pip"
    fake.mkdir(parents=True)
    marker = tmp_path / "pip_called"
    (fake / "__init__.py").write_text("")
    (fake / "__main__.py").write_text(f"open({str(marker)!r}, 'w').write('called')\n")
    bport, uport = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(fake.parent), str(ROOT)]),
               **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "aefs_tpu_torch.run", "--backend-port", str(bport),
         "--ui-port", str(uport)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, bport, uport, marker


def _children(pid):
    kids = []
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            kids.append(int(stat.parent.name))
    return kids


def _pids(text):
    """The children's pids as the launcher prints them."""
    return [int(w) for w in re.findall(r"\(pid (\d+)\)", text)]


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_launcher_serves_and_sigterm_leaves_no_child(tmp_path):
    """The launcher with ``AEFS_PLATFORM=cpu`` starts the port's backend and
    UI server: /config.json answers with the backend's port and a real
    client gets its stats; it never calls pip (sounddevice is absent here);
    SIGTERM ends it and leaves no child."""
    proc, bport, uport, marker = _launch(tmp_path, {"AEFS_PLATFORM": "cpu"})
    try:
        deadline = time.monotonic() + 90
        cfg = None
        while cfg is None:
            assert proc.poll() is None and time.monotonic() < deadline
            try:
                cfg = json.loads(_http_get(uport, "/config.json")[1])
            except OSError:
                time.sleep(0.2)
        assert cfg["ws_port"] == bport

        async def stats():
            for _ in range(300):
                try:
                    async with ws.connect(f"ws://127.0.0.1:{bport}") as client:
                        await client.send(json.dumps({"command": "get_stats"}))
                        return await _recv(client, "stats", [], timeout=60)
                except OSError:
                    await asyncio.sleep(0.2)
            raise AssertionError("the backend never answered")

        assert asyncio.run(stats())["sample_rate"] == FS
        kids = _children(proc.pid)
        assert len(kids) == 2, kids
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=30)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, text
    assert sorted(kids) == sorted(_pids(text)) and all(_gone(k) for k in kids), text
    assert not marker.exists()
    assert "mic mode disabled" in text and "Shutting down" in text


def test_launcher_reports_a_dead_backend(tmp_path):
    """A backend that exits at start (here: asked for the card on a machine
    without one) is reported, and the launcher tears the UI server down."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the backend would start")
    proc, _, _, marker = _launch(tmp_path, {"AEFS_PLATFORM": "cuda"})
    text = proc.communicate(timeout=90)[0]
    assert "Service 'backend' exited (1); shutting down" in text, text
    assert "no CUDA card" in text
    assert len(_pids(text)) == 2 and all(_gone(k) for k in _pids(text))
    assert not marker.exists()
