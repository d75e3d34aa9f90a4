"""Protocol soak of the port's servers (counterpart of tests/test_soak.py,
with its seeds, chains, junk and op counts): seeded random command
storms, valid, invalid and malformed interleaved, against the port's
backend and pool server on the CPU.  Chain rebuilds (each a new step
runner, the old chain released), ``update_param`` writes into the
runner's static targets, sessions saved and resumed, and pool claims and
releases all run while blocks step; the servers must stay fully
functional afterwards."""

import asyncio
import json

import numpy as np
import pytest
import torch

from test_soak import CHAINS, JUNK, _wav_url

ws = pytest.importorskip("websockets")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """The port's handler picks its device per connection: here the CPU."""
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_backend_protocol_soak(tmp_path):
    """~100 randomized ops against the single-session backend, then proof
    that it still does real work (a file round trip and stats)."""

    async def scenario():
        from aefs_tpu_torch.server import backend

        server = await ws.serve(backend.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        rng = np.random.default_rng(42)
        url = _wav_url()
        sess = str(tmp_path / "soak_sess")
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                for _ in range(100):
                    op = rng.integers(0, 12)
                    if op == 10:  # live file stream (flat-out) ...
                        await c.send(json.dumps({"command": "stream_file", "contents": url,
                                                 "realtime": False}))
                    elif op == 11:  # ... raced against stop
                        await c.send(json.dumps({"command": "stop"}))
                    elif op <= 2:  # param storm (valid + invalid mixed)
                        await c.send(json.dumps({
                            "command": "update_param",
                            "effect_id": rng.choice(["f", "d", "w", "g", "zz"]),
                            "param": rng.choice(["cutoff_hz", "delay_ms", "drive", "bogus"]),
                            "value": float(rng.uniform(-1e6, 1e6))}))
                    elif op <= 4:  # junk
                        await c.send(str(JUNK[int(rng.integers(len(JUNK)))]))
                    elif op <= 6:  # chain churn
                        await c.send(json.dumps({
                            "command": "build_chain",
                            "config": CHAINS[int(rng.integers(len(CHAINS)))]}))
                    elif op == 7:
                        await c.send(json.dumps({"command": "get_stats"}))
                    elif op == 8:
                        await c.send(json.dumps({"command": "save_session", "path": sess}))
                    else:
                        await c.send(json.dumps({
                            "command": "resume_session",
                            "path": rng.choice([sess, str(tmp_path / "no")])}))
                    if rng.random() < 0.1:  # drain opportunistically
                        try:
                            await asyncio.wait_for(c.recv(), 0.05)
                        except asyncio.TimeoutError:
                            pass

                await c.send(json.dumps({"command": "build_chain", "config": CHAINS[1]}))
                await c.send(json.dumps({"command": "process_file", "contents": url}))
                for _ in range(200):
                    msg = json.loads(await asyncio.wait_for(c.recv(), 120))
                    if msg["type"] == "file_processed":
                        break
                else:
                    raise AssertionError("no file_processed after soak")
                out = np.asarray(msg["processed_samples"], np.float64)
                assert out.shape[0] == 2048 and np.all(np.isfinite(out))
                await c.send(json.dumps({"command": "get_stats"}))
                for _ in range(50):
                    msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                    if msg["type"] == "stats":
                        break
                else:
                    raise AssertionError("no stats after soak")
        finally:
            server.close()
            await server.wait_closed()
        assert backend.connected_client is None

    asyncio.run(scenario())


def test_pool_protocol_soak():
    """Three concurrent clients storm a 3-slot pool (streams, param churn,
    stats, junk, session churn by reconnecting); every stream_block comes
    back finite, and the pool ends healthy."""

    async def scenario():
        from aefs_tpu_torch.server.pool import PoolServer, SessionPool

        pool = SessionPool(CHAINS[2], n_slots=3, device="cpu")
        srv = PoolServer(pool)
        server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        batcher = asyncio.create_task(srv.batcher())

        async def client_run(seed):
            rng = np.random.default_rng(seed)
            for _round in range(2):  # reconnect churn: claim -> release -> claim
                async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                    ready = json.loads(await c.recv())
                    assert ready["type"] == "session_ready"
                    n = ready["blocksize"]
                    for _ in range(15):
                        op = rng.integers(0, 5)
                        if op <= 2:
                            await c.send(json.dumps({
                                "command": "stream_block",
                                "audio": (0.2 * rng.standard_normal(n))
                                .astype(np.float32).tolist()}))
                            while True:
                                msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                                if msg["type"] == "processed_block":
                                    break
                            out = np.asarray(msg["output"], np.float64)
                            assert out.shape[0] == n and np.all(np.isfinite(out))
                        elif op == 3:
                            await c.send(json.dumps({
                                "command": "update_param", "effect_id": "d",
                                "param": rng.choice(["delay_ms", "feedback", "nope"]),
                                "value": float(rng.uniform(-10, 2000))}))
                        else:
                            await c.send(str(JUNK[int(rng.integers(len(JUNK)))]))

        try:
            await asyncio.gather(*(client_run(100 + k) for k in range(3)))
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                ready = json.loads(await c.recv())
                assert ready["type"] == "session_ready"
                await c.send(json.dumps({"command": "get_pool_stats"}))
                while True:
                    msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                    if msg["type"] == "pool_stats":
                        break
                assert msg["slots"] == 3 and msg["active"] == 1
        finally:
            batcher.cancel()
            server.close()
            await server.wait_closed()
        # Healthy afterwards: every slot's state finite in the runner's buffers.
        for group in pool.state[0]:
            if group.is_floating_point():
                assert torch.isfinite(group).all()

    asyncio.run(scenario())
