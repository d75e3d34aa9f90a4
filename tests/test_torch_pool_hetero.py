"""Heterogeneous-topology serving in the PyTorch port (MultiPool,
canonical_topology), ported from tests/test_pool_hetero.py and held
against the JAX package on the CPU.

Sessions bucket by chain topology: one batched step per bucket, slots
migrate on per-session build_chain, and a migrated or joining session is
BIT-IDENTICAL to the same session served by a dedicated single-topology
pool.  ``canonical_topology`` returns exactly what JAX's does: the key
string, the canonical config and the session ids.
"""

import asyncio
import json
import threading

import numpy as np
import pytest

from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.server.pool import canonical_topology as jax_canonical_topology
from aefs_tpu_torch.server import pool as poolmod
from aefs_tpu_torch.server.pool import MultiPool, PoolServer, SessionPool, canonical_topology
from __graft_entry__ import FLAGSHIP

CFG_A = [{"effect_id": "f", "type": "filter",
          "params": {"filter_type": 0, "cutoff_hz": 8000, "q": 0.707}}]
CFG_B = [{"effect_id": "d", "type": "delay",
          "params": {"delay_ms": 120.0, "feedback": 0.4, "mix_dry": 0.7, "mix_wet": 0.5}},
         {"effect_id": "g", "type": "gate",
          "params": {"threshold_db": -45.0, "attack_ms": 5.0, "release_ms": 80.0}}]
# same topology as CFG_B, different ids and params (bucket-sharing case)
CFG_C = [{"effect_id": "del2", "type": "delay",
          "params": {"delay_ms": 250.0, "feedback": 0.2, "mix_dry": 1.0, "mix_wet": 0.3}},
         {"effect_id": "gate2", "type": "gate",
          "params": {"threshold_db": -60.0, "attack_ms": 2.0, "release_ms": 40.0}}]


def _noise(rng, n):
    return (0.3 * rng.standard_normal(n)).astype(np.float32)


def _tone(n, f, fs=48000, amp=0.3):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.float32)


def _par(fb):
    return [{"effect_id": "p", "type": "parallel",
             "branches": [[{"effect_id": "x", "type": "delay", "params": {"feedback": fb}}],
                          [{"effect_id": "y", "type": "gate", "params": {}}]],
             "params": {"gain_0": 1.0}}]


def _branch(branch):
    return [dict(_par(0.2)[0], branches=[branch])]


# Every config of tests/test_pool_hetero.py's key test, by name, with the
# grid flag it is keyed under.
TOPOLOGIES = {
    "A": (CFG_A, False), "B": (CFG_B, False), "C": (CFG_C, False),
    "static": ([dict(CFG_A[0], params=dict(CFG_A[0]["params"]), comb_times_ms=[10.0, 20.0])],
               False),
    "oct12-grid": ([{"effect_id": "o", "type": "octaver", "params": {"semitones": -12.0}}], True),
    "oct24-grid": ([{"effect_id": "o", "type": "octaver", "params": {"semitones": -24.0}}], True),
    "oct12": ([{"effect_id": "o", "type": "octaver", "params": {"semitones": -12.0}}], False),
    "oct-7-grid": ([{"effect_id": "o", "type": "octaver", "params": {"semitones": -7.0}}], True),
    "par0.2": (_par(0.2), False), "par0.8": (_par(0.8), False),
    "par2": ([dict(_par(0.2)[0], branches=[[{"type": "delay", "params": {}}]])], False),
    "skip_mb": (_branch([{"type": "multiband", "crossover_hz": [300.0]},
                         {"type": "delay", "params": {}}]), False),
    "skip_un": (_branch([{"type": "bogus"}, {"type": "delay", "params": {}}]), False),
    "skip_pp": (_branch([{"type": "parallel", "branches": []},
                         {"type": "delay", "params": {}}]), False),
    "kept": (_branch([{"type": "delay", "params": {}}]), False),
    "extra": (_branch([{"type": "delay", "params": {}, "ignored_key": 7}]), False),
    "flagship": (FLAGSHIP, False),
    **{f"preset:{k}": (v, False) for k, v in DEFAULT_PRESETS.items()},
}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_canonical_topology_equals_jax(name):
    """Key string, canonical config and session ids, byte for byte."""
    cfg, grid = TOPOLOGIES[name]
    assert canonical_topology(cfg, grid=grid) == jax_canonical_topology(cfg, grid=grid)


def test_canonical_topology_keys():
    """Live params and effect ids never split buckets; static config does;
    parallel containers key on branch structure exactly as the chain build
    reads it (tests/test_pool_hetero.py:test_canonical_topology_keys)."""
    key = {k: canonical_topology(cfg, grid)[0] for k, (cfg, grid) in TOPOLOGIES.items()}
    _, canon_a, _ = canonical_topology(CFG_A)
    assert key["B"] == key["C"] and canonical_topology(CFG_C)[2] == ["del2", "gate2"]
    assert key["A"] != key["B"] and canon_a[0]["effect_id"] == "fx0"
    assert key["static"] != key["A"]
    assert key["oct12-grid"] != key["oct24-grid"]
    assert key["par0.2"] == key["par0.8"] and key["par2"] != key["par0.2"]
    assert key["skip_mb"] == key["skip_un"] == key["skip_pp"] != key["kept"] == key["extra"]


def test_multipool_heterogeneous_bit_parity():
    """Two topologies live at once in one MultiPool; each session bit-matches
    the same session served by a dedicated single-topology pool, including a
    live update_param routed through the session-id map and a session that
    JOINS an already-running bucket with its own params."""
    mp = MultiPool(CFG_A, n_slots=2, device="cpu")
    assert [eid for eid, _ in mp.default_pool.chain.effects] == ["f"]
    sa = mp.default_pool.claim()
    key_b, pool_b, sb, tmap_b, single_b, idmap_b = mp.build_session(CFG_B)
    assert pool_b is not mp.default_pool and sb is not None
    assert len(mp.buckets()) == 2
    pa = SessionPool(CFG_A, n_slots=2, device="cpu")
    ra = pa.claim()
    pb = SessionPool(CFG_B, n_slots=2, device="cpu")
    rb = pb.claim()
    rng = np.random.default_rng(3)
    sc = pc = rc = None
    for i in range(16):
        xa, xb = _noise(rng, mp.blocksize), _noise(rng, mp.blocksize)
        if i == 5:
            assert set(idmap_b) == {"d", "g"}
            pool_b.update_param(sb, idmap_b["d"], "feedback", 0.7)
            pb.update_param(rb, "d", "feedback", 0.7)
        if i == 8:
            key_c, pool_c, sc, tmap_c, single_c, idmap_c = mp.build_session(CFG_C)
            assert pool_c is pool_b and key_c == key_b and sc not in (None, sb)
            pc = SessionPool(CFG_C, n_slots=2, device="cpu")
            rc = pc.claim()
        blocks = {sb: xb}
        if sc is not None:
            xc = _noise(rng, mp.blocksize)
            blocks[sc] = xc
        oa = mp.default_pool.step_blocks({sa: xa})[sa]
        ob_all = pool_b.step_blocks(blocks)
        np.testing.assert_array_equal(oa, pa.step_blocks({ra: xa})[ra], err_msg=f"block {i}")
        np.testing.assert_array_equal(ob_all[sb], pb.step_blocks({rb: xb})[rb],
                                      err_msg=f"block {i}: migrated session != solo")
        if sc is not None:
            np.testing.assert_array_equal(ob_all[sc], pc.step_blocks({rc: xc})[rc],
                                          err_msg=f"block {i}: mid-stream joiner != solo")


def test_multipool_same_topology_rebuild_and_limits():
    """Same-topology build_chain rebuilds in place; the bucket limit rejects
    new topologies when nothing is evictable and evicts sessionless buckets
    when something is."""
    mp = MultiPool(CFG_A, n_slots=2, max_buckets=2, device="cpu")
    key_b, pool_b, sb, _, _, _ = mp.build_session(CFG_B)
    cfg_new = [{"effect_id": "w", "type": "waveshaper", "params": {"drive": 4.0}}]
    with pytest.raises(RuntimeError, match="bucket limit"):
        mp.build_session(cfg_new)
    assert len(mp.buckets()) == 2
    key_c, pool_c, sc, _, _, _ = mp.build_session(CFG_C, current=(pool_b, sb))
    assert pool_c is pool_b and sc == sb
    pool_b.release(sb)
    key_w, pool_w, sw, _, _, _ = mp.build_session(cfg_new)
    buckets = mp.buckets()
    assert key_b not in buckets and key_w in buckets and mp.default_key in buckets
    assert pool_b.state is None  # the evicted bucket was closed
    assert sw is not None
    assert np.all(np.isfinite(pool_w.step_blocks({sw: _tone(mp.blocksize, 1000)})[sw]))


def test_multipool_concurrent_same_key_builds_one_bucket(monkeypatch):
    """N sessions requesting the SAME new topology at once produce exactly
    ONE bucket: the first caller reserves the key and builds outside the
    map lock; the others wait on its event."""
    mp = poolmod.MultiPool(CFG_A, n_slots=4, device="cpu")
    built = []
    real = poolmod.SessionPool

    class CountingPool(real):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(poolmod, "SessionPool", CountingPool)
    start = threading.Barrier(4)
    results, errors = [], []

    def worker():
        try:
            start.wait(30)
            results.append(mp.build_session(CFG_B))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "build_session deadlocked"
    assert not errors, errors
    assert len(built) == 1, f"{len(built)} duplicate bucket builds"
    assert len({id(r[1]) for r in results}) == 1
    slots = [r[2] for r in results]
    assert None not in slots and len(set(slots)) == 4


def test_multipool_randomized_migration_hammer():
    """Threads stream while randomly rebuilding to other topologies
    (handler semantics: claim-new-then-release-old), with max_buckets forcing
    eviction churn: no deadlock, no exception, finite audio, a consistent
    final bucket map."""
    topologies = [
        CFG_A, CFG_B,
        [{"effect_id": "w", "type": "waveshaper", "params": {"drive": 4.0, "mix": 1.0}}],
        [{"effect_id": "g", "type": "gate",
          "params": {"threshold_db": -50.0, "attack_ms": 3.0, "release_ms": 60.0}}],
    ]
    mp = MultiPool(CFG_A, n_slots=4, max_buckets=3, device="cpu")
    errors = []
    steplocks, steplock_guard = {}, threading.Lock()

    def step(pool, slot, x):
        # One stepper per bucket, like the product's one batcher per bucket.
        with steplock_guard:
            lk = steplocks.setdefault(id(pool), threading.Lock())
        with lk:
            return pool.step_blocks({slot: x})[slot]

    def worker(tid):
        rng = np.random.default_rng(100 + tid)
        pool, slot = mp.default_pool, mp.default_pool.claim()
        assert slot is not None
        try:
            for _ in range(4):
                cfg = topologies[rng.integers(len(topologies))]
                try:
                    _k, npool, nslot, _t, _s, _i = mp.build_session(cfg, current=(pool, slot))
                except RuntimeError:
                    continue  # bucket limit: keep the current placement
                if nslot is None:
                    continue
                if npool is not pool:
                    pool.release(slot)
                    pool, slot = npool, nslot
                for _ in range(int(rng.integers(1, 3))):
                    assert np.all(np.isfinite(step(pool, slot, _noise(rng, mp.blocksize))))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((tid, e))
        finally:
            pool.release(slot)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive(), "migration hammer deadlocked"
    assert not errors, errors
    buckets = mp.buckets()
    assert mp.default_key in buckets and len(buckets) <= 3
    assert all(p.active_count() == 0 for p in buckets.values())
    for p in buckets.values():
        s = p.claim()
        assert np.all(np.isfinite(p.step_blocks({s: _tone(mp.blocksize, 440)})[s]))
        p.release(s)


def test_pool_build_chain_migration_ws():
    """End to end over WebSockets: a malformed build_chain answers with an
    error, a session migrates to its own topology, its params route
    through ITS effect ids, stats report both buckets, the default bucket
    keeps serving, and both slots come back when the sessions leave."""
    pytest.importorskip("websockets")

    async def scenario():
        import websockets as ws

        pool = SessionPool(CFG_A, n_slots=2, device="cpu")
        srv = PoolServer(pool)
        server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        batcher = asyncio.create_task(srv.batcher())

        async def stream_rms(client, freq, n_blocks=8):
            rms = None
            for _ in range(n_blocks):
                await client.send(json.dumps({"command": "stream_block",
                                              "audio": _tone(pool.blocksize, freq).tolist()}))
                msg = json.loads(await asyncio.wait_for(client.recv(), 60))
                assert msg["type"] == "processed_block"
                rms = float(np.sqrt(np.mean(np.square(msg["output"]))))
            return rms

        try:
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as a, \
                    ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as b:
                ra = json.loads(await a.recv())
                rb = json.loads(await b.recv())
                assert {ra["type"], rb["type"]} == {"session_ready"}
                await a.send(json.dumps({"command": "build_chain", "effects_config": [
                    {"type": "delay", "params": "oops"}]}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 60))
                assert msg["type"] == "error", msg
                my_cfg = [{"effect_id": "my-lp", "type": "filter",
                           "params": {"filter_type": 0, "cutoff_hz": 300.0, "q": 0.707}},
                          {"effect_id": "my-gate", "type": "gate",
                           "params": {"threshold_db": -90.0, "attack_ms": 1.0,
                                      "release_ms": 100.0}}]
                await a.send(json.dumps({"command": "build_chain", "effects_config": my_cfg}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 120))
                assert msg["type"] == "chain_built", msg
                assert await stream_rms(a, 6000) < 0.02
                assert await stream_rms(b, 6000) > 0.1
                await a.send(json.dumps({"command": "update_param", "effect_id": "my-lp",
                                         "param": "cutoff_hz", "value": 20000.0, "ack": True}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 60))
                assert msg["type"] == "param_ack" and msg["ok"], msg
                assert await stream_rms(a, 6000, n_blocks=40) > 0.1
                await a.send(json.dumps({"command": "get_pool_stats"}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 60))
                assert msg["type"] == "pool_stats" and msg["n_buckets"] == 2
                assert sorted(bk["active"] for bk in msg["buckets"]) == [1, 1]
                assert isinstance(msg["realtime_ok"], bool)
                await a.send(json.dumps({"command": "update_param", "effect_id": "nope",
                                         "param": "cutoff_hz", "value": 100.0, "ack": True}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 60))
                assert msg["type"] == "param_ack" and not msg["ok"]
            await asyncio.sleep(0.2)
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                json.loads(await c.recv())
                await c.send(json.dumps({"command": "get_pool_stats"}))
                msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                assert msg["slots"] == 2 and msg["active"] == 1
        finally:
            batcher.cancel()
            server.close()
            await server.wait_closed()

    asyncio.run(scenario())
