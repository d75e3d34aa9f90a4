"""The multi-session pool of the PyTorch port (aefs_tpu_torch/server/pool.py)
and the slot axis under it, against the JAX package on the CPU.

- ``Chain.state_axes`` / ``batch_state`` / ``graft_slot_state`` agree with
  JAX's on the flagship and all 17 presets: the same paths, the same
  lockstep leaves, the same batched shapes and values.
- Every preset steps with a leading slot axis: each slot of a 3-slot pool
  with its own params stays within -120 dBFS of the solo chain.
- The plain K1 and K3 steps take the slot axis bit for bit.
- The port's pool is within -90 dBFS of JAX's pool on the flagship, "Lush
  Chorus" and "Rain Delay"; "Multiband Master" is held to the float64
  oracle chain (the stated exception: JAX's float32 biquads at its 150 Hz
  crossover, tests/test_torch_chain.py).
- Ports of tests/test_pool.py where the port has the feature: per-session
  params over the WebSocket protocol, the batcher surviving a failed step,
  the parallel-branch chain, pipelined bit parity and flush, a discarded
  pool freeing with gc disabled, a failed readback resetting the state.
"""

import asyncio
import copy
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.server.pool import SessionPool as JaxPool
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import flatten_like_jax, unflatten_like_jax
from aefs_tpu_torch.models.octaver import Octaver
from aefs_tpu_torch.ops.kernels.resample import chorus_step_plain, octaver_step_plain
from aefs_tpu_torch.server.pool import PoolServer, SessionPool
from __graft_entry__ import FLAGSHIP

from helpers import bursts, mono, tones
from oracles import err_dbfs

FS = 48000
N = 256
S = 3
CONFIGS = {"flagship": FLAGSHIP, **DEFAULT_PRESETS}
CFG = [{"effect_id": "f", "type": "filter",
        "params": {"filter_type": 0, "cutoff_hz": 8000, "q": 0.707}}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tone(n, f, fs=FS, amp=0.3):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.float32)


def _jax_leaves(tree):
    """(path, leaf) pairs of a JAX tree in flatten order, None leaves kept."""
    pairs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda v: v is None)[0]
    return [("".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}" for k in path), v)
            for path, v in pairs]


def _path_tree(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _path_tree(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_path_tree(v, f"{prefix}/{i}") for i, v in enumerate(tree))
    return prefix


@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_state_methods_match_jax(name):
    """state_axes, batch_state and graft_slot_state against JAX's, leaf for
    leaf in JAX's order: the same lockstep leaves, the same batched shapes,
    dtypes and values, and a graft of a random single state into slot 1
    that equals JAX's."""
    jchain, jstate, _ = jax_build(copy.deepcopy(CONFIGS[name]), FS, N, channels_in=1)
    chain, state, _ = build_chain(copy.deepcopy(CONFIGS[name]), FS, N, channels_in=1,
                                  device="cpu")
    jaxes = _jax_leaves(jchain.state_axes())
    axes = flatten_like_jax(chain.state_axes())
    assert flatten_like_jax(_path_tree(state)) == [p for p, _ in _jax_leaves(jstate)]
    assert axes == [a for _, a in jaxes]

    jb = jax.tree.leaves(jchain.batch_state(jstate, S))
    pb = flatten_like_jax(chain.batch_state(state, S))
    assert [tuple(t.shape) for t in pb] == [a.shape for a in jb]
    assert all(np.array_equal(t.numpy(), np.asarray(a)) for t, a in zip(pb, jb))
    lockstep = [t for t, a in zip(flatten_like_jax(state), axes) if a is None]
    assert all(t.data_ptr() not in {b.data_ptr() for b in pb} for t in lockstep)

    rng = np.random.default_rng(5)
    leaves = []
    for t in flatten_like_jax(state):
        a = t.numpy()
        if a.dtype.kind == "f":
            leaves.append(rng.standard_normal(a.shape).astype(a.dtype))
        else:
            leaves.append(rng.integers(0, 1000, a.shape).astype(a.dtype))
    single = unflatten_like_jax(state, [torch.from_numpy(a) for a in leaves])
    jsingle = jax.tree.unflatten(jax.tree.structure(jstate), [jnp.asarray(a) for a in leaves])
    got = flatten_like_jax(chain.graft_slot_state(chain.batch_state(state, S), single, 1))
    want = jax.tree.leaves(jchain.graft_slot_state(jchain.batch_state(jstate, S), jsingle, 1))
    assert all(np.array_equal(t.numpy(), np.asarray(a)) for t, a in zip(got, want))


def _slot_params(chain):
    """Per-slot param changes: slot 1 moves the first effect's first live
    param, slot 2 the last effect's, each to a value inside its range."""
    changes = {}
    for slot, (eid, model) in ((1, chain.effects[0]), (2, chain.effects[-1])):
        name, spec = next(iter(model.PARAMS.items()))
        changes[slot] = (eid, name, spec.lo + (spec.hi - spec.lo) * (0.2 + 0.2 * slot))
    return changes


@pytest.mark.parametrize("name", list(DEFAULT_PRESETS))
def test_pool_slots_match_solo_chain(name):
    """A 3-slot pool of every preset, each slot on its own input and with
    its own params, against the solo chain on the same stream: 8 blocks of
    256, within -120 dBFS (the same ops with a leading slot axis)."""
    cfg = DEFAULT_PRESETS[name]
    pool = SessionPool(cfg, n_slots=S, device="cpu")
    changes = _slot_params(pool.chain)
    solos = []
    for slot in range(S):
        chain, state, tmap = build_chain(cfg, FS, N, device="cpu")
        if slot in changes:
            eid, param, value = changes[slot]
            assert pool.update_param(slot, eid, param, value) is None
            tmap.setdefault(eid, {})[param] = value
        solos.append([chain, state, chain.targets(tmap)])
    x = mono(bursts(S * 8 * N, amp=0.4, seed=21))[:, 0].reshape(S, 8, N)
    worst = -np.inf
    for b in range(8):
        out = pool.step_blocks({s: x[s, b] for s in range(S)})
        for s, solo in enumerate(solos):
            solo[1], y = solo[0].process_block(solo[1], solo[2], torch.from_numpy(x[s, b][None]))
            assert out[s].shape == (N, 2) and np.all(np.isfinite(out[s]))
            worst = max(worst, err_dbfs(out[s], y.numpy().T))
    assert worst <= -120, worst


@pytest.mark.parametrize("blocks", [(-12.0,) * 3 + (-5.0,) * 3, (7.0,) * 2 + (7.5,) * 2])
def test_octaver_plain_step_slot_axis_bitwise(blocks):
    """The plain K1 step on (S, 2, N) equals S single-stream calls bit for
    bit, each slot with its own semitones (one gliding, so it re-anchors
    mid-run), mix and ring, one slot from n_abs near 2^28."""
    rng = np.random.default_rng(3)
    one = Octaver(FS, N, device="cpu").init_state()
    singles = []
    for s in range(S):
        st = {k: v.clone() for k, v in one.items()}
        st["hist"] = torch.from_numpy((0.3 * rng.standard_normal(st["hist"].shape))
                                      .astype(np.float32))
        singles.append(st)
    singles[2]["n_abs"] = torch.tensor((1 << 28) - 300, dtype=torch.int32)
    batched = {k: torch.stack([st[k] for st in singles]) for k in one}
    for b, semi in enumerate(blocks):
        x = torch.from_numpy((0.3 * rng.standard_normal((S, 2, N))).astype(np.float32))
        semis = [semi, -7.0 - 0.5 * b, 12.0]
        mixes = [0.4, 0.9, 0.1]
        p = {"semitones": torch.tensor(semis), "mix": torch.tensor(mixes)}
        batched, y = octaver_step_plain(batched, p, x)
        for s in range(S):
            singles[s], ys = octaver_step_plain(
                singles[s], {"semitones": torch.tensor(semis[s]), "mix": torch.tensor(mixes[s])},
                x[s])
            assert torch.equal(y[s], ys)
            for k, v in singles[s].items():
                assert torch.equal(batched[k][s], v), k


def test_chorus_plain_step_slot_axis_bitwise():
    """The plain K3 step on (S, 2, N) equals S single-stream calls bit for
    bit, each slot with its own rate (one changing mid-run), depth, base,
    mix and spread, one slot's delay law cut by the clamp."""
    rng = np.random.default_rng(4)
    hist_len = 2408
    singles = [{"hist": torch.from_numpy((0.3 * rng.standard_normal((2, hist_len)))
                                         .astype(np.float32)),
                "ph_hi": torch.tensor(0.1 * s), "ph_lo": torch.tensor(0.0)} for s in range(S)]
    batched = {k: torch.stack([st[k] for st in singles]) for k in singles[0]}
    fixed = {"depth_ms": [4.0, 10.0, 2.0], "base_ms": [14.0, 1.0, 30.0],
             "mix": [0.5, 1.0, 0.2], "spread": [0.25, 0.0, 0.5]}
    for b in range(6):
        rates = [0.6 if b < 3 else 4.0, 2.0, 9.5]
        p = {k: torch.tensor(v) for k, v in {**fixed, "rate_hz": rates}.items()}
        x = torch.from_numpy((0.3 * rng.standard_normal((S, 2, N))).astype(np.float32))
        batched, y = chorus_step_plain(batched, p, x, FS)
        for s in range(S):
            singles[s], ys = chorus_step_plain(
                singles[s], {k: v[s] for k, v in p.items()}, x[s], FS)
            assert torch.equal(y[s], ys)
            for k, v in singles[s].items():
                assert torch.equal(batched[k][s], v), k


# The JAX pool's comparison: (config, per-slot param changes, program).
JAX_CASES = {
    "flagship": (FLAGSHIP, {1: [("o", "semitones", -7.0), ("d", "feedback", 0.5)],
                            2: [("o", "semitones", 12.0), ("f", "cutoff_hz", 1500.0)]},
                 "bursts"),
    "Lush Chorus": (DEFAULT_PRESETS["Lush Chorus"],
                    {1: [("lc1", "rate_hz", 2.0)], 2: [("lc1", "depth_ms", 8.0)]}, "tones"),
    "Rain Delay": (DEFAULT_PRESETS["Rain Delay"],
                   {1: [("rd1", "delay_ms", 120.0)], 2: [("rd2", "rt60_s", 4.0)]}, "bursts"),
}


def _slot_inputs(kind, blocks, seed):
    frames = S * blocks * N
    x = tones(frames, amp=0.4) if kind == "tones" else bursts(frames, amp=0.4, seed=seed)
    return mono(x)[:, 0].reshape(S, blocks, N)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_pool_vs_jax_pool(name):
    """The port's SessionPool against JAX's on the CPU, slot for slot, with
    per-slot params set by update_param: within -90 dBFS."""
    cfg, changes, kind = JAX_CASES[name]
    pool = SessionPool(cfg, n_slots=S, device="cpu")
    jpool = JaxPool(cfg, n_slots=S)
    for slot, ups in changes.items():
        for eid, param, value in ups:
            assert pool.update_param(slot, eid, param, value) is None
            assert jpool.update_param(slot, eid, param, value) is None
    x = _slot_inputs(kind, 8, seed=22)
    got, want = [], []
    for b in range(8):
        blocks = {s: x[s, b] for s in range(S)}
        got.append(pool.step_blocks(blocks))
        want.append(jpool.step_blocks(blocks))
    for s in range(S):
        err = err_dbfs(np.concatenate([o[s] for o in got]), np.concatenate([o[s] for o in want]))
        assert err <= -90, (s, err)
    jpool.close()


def test_multiband_master_pool_vs_oracle():
    """"Multiband Master" in a 3-slot pool, each slot against the float64
    oracle chain on its own stream at -80 dBFS: the stated JAX exception
    (its float32 biquads at the 150 Hz crossover), as in
    tests/test_torch_chain.py."""
    from test_torch_chain import _oracle_chain

    cfg = DEFAULT_PRESETS["Multiband Master"]
    pool = SessionPool(cfg, n_slots=S, device="cpu")
    x = _slot_inputs("bursts", 8, seed=23)
    outs = [pool.step_blocks({s: x[s, b] for s in range(S)}) for b in range(8)]
    for s in range(S):
        got = np.concatenate([o[s] for o in outs])
        oracle = np.clip(_oracle_chain(cfg, x[s].reshape(-1, 1)), -1.0, 1.0)
        assert err_dbfs(got, oracle) <= -80, (s, err_dbfs(got, oracle))


def test_pool_grid_and_shard_options():
    """grid=True bakes the whole-octave octaver for exact-grid serving (its
    semitones stop being live; tests/test_torch_grid.py holds the mode in
    full); shard=True on one device is what JAX does there: nothing."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.9}}]
    grid = SessionPool(cfg, n_slots=2, grid=True, device="cpu")
    assert grid.grid and dict(grid.chain.effects)["o"]._grid_e == -1
    assert "grid-specialized" in grid.update_param(0, "o", "semitones", -7)
    pa = SessionPool(cfg, n_slots=2, device="cpu")
    pb = SessionPool(cfg, n_slots=2, shard=True, device="cpu")
    blk = _tone(N, 440)
    for _ in range(3):
        np.testing.assert_array_equal(pa.step_blocks({0: blk})[0], pb.step_blocks({0: blk})[0])


def test_pool_server_main_refuses_grid_before_serving(monkeypatch, tmp_path):
    """``python -m aefs_tpu_torch.server.pool --grid`` parses its options,
    picks the device and builds a grid default bucket before it serves
    (the serve call is stubbed to stop there)."""
    import aefs_tpu_torch.server.pool as pool_mod

    cfg_path = tmp_path / "octaver.json"
    cfg_path.write_text(json.dumps(
        [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.9}}]))

    seen = {}

    class Stop(Exception):
        pass

    class FakeWs:
        @staticmethod
        def serve(handler, host, port, max_size):
            seen["server"] = handler.__self__
            raise Stop

    monkeypatch.setattr(pool_mod, "ws", FakeWs)
    with pytest.raises(Stop):
        asyncio.run(pool_mod.main(["--device", "cpu", "--grid", "--slots", "2", "--port", "0",
                                   "--config", str(cfg_path)]))
    multi = seen["server"].multi
    assert multi.grid and multi.default_pool.grid and multi.default_pool._phase_rows


def test_pool_defaults_to_the_card():
    """Like every entry point of the port, a pool runs on the card unless
    the caller asks for the CPU; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would build there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SessionPool(CFG, n_slots=2)


async def _serve(pool):
    import websockets as ws

    srv = PoolServer(pool)
    server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
    return srv, server, server.sockets[0].getsockname()[1], asyncio.create_task(srv.batcher())


async def _stop(server, batcher):
    batcher.cancel()
    server.close()
    await server.wait_closed()


def test_pool_two_sessions_per_session_params():
    """Two sessions share a pool with PER-SESSION params over WebSockets;
    a third is refused (pool full); stats report the pool; a released slot
    comes back fresh for the next claimant."""
    pytest.importorskip("websockets")

    async def scenario():
        import websockets as ws

        pool = SessionPool(CFG, n_slots=2, device="cpu")
        srv, server, port, batcher = await _serve(pool)

        async def rms_of_stream(client, n_blocks=40):
            vals = []
            for _ in range(n_blocks):
                await client.send(json.dumps({"command": "stream_block",
                                              "audio": _tone(pool.blocksize, 6000).tolist()}))
                msg = json.loads(await asyncio.wait_for(client.recv(), 60))
                assert msg["type"] == "processed_block"
                vals.append(np.sqrt(np.mean(np.square(msg["output"]))))
            return float(np.mean(vals[n_blocks // 2:]))

        try:
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as a, \
                    ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as b:
                ra = json.loads(await a.recv())
                rb = json.loads(await b.recv())
                assert {ra["slot"], rb["slot"]} == {0, 1}
                assert ra["chain"] == CFG
                await b.send(json.dumps({"command": "update_param", "effect_id": "f",
                                         "param": "cutoff_hz", "value": 300}))
                rms_a, rms_b = await asyncio.gather(rms_of_stream(a), rms_of_stream(b))
                assert rms_a > 0.1, rms_a
                assert rms_b < rms_a / 4, (rms_a, rms_b)
                async with ws.connect(f"ws://127.0.0.1:{port}") as c:
                    msg = json.loads(await asyncio.wait_for(c.recv(), 30))
                    assert msg["type"] == "error" and "full" in msg["error"]
                await a.send(json.dumps({"command": "get_pool_stats"}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 30))
                assert msg["type"] == "pool_stats"
                assert msg["slots"] == 2 and msg["active"] == 2
                assert msg["deadline_ms"] == pytest.approx(msg["blocksize"] / FS * 1000, abs=1e-3)
                assert isinstance(msg["realtime_ok"], bool)
            await asyncio.sleep(0.2)
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                json.loads(await c.recv())
                for _ in range(6):
                    await c.send(json.dumps({"command": "stream_block",
                                             "audio": _tone(pool.blocksize, 6000).tolist()}))
                    msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                assert np.sqrt(np.mean(np.square(msg["output"]))) > 0.1
        finally:
            await _stop(server, batcher)

    asyncio.run(scenario())


def test_pool_batcher_survives_step_failure():
    """A failing step kills neither the batcher task nor the session: the
    waiter gets the error, the next block processes normally."""
    pytest.importorskip("websockets")

    async def scenario():
        import websockets as ws

        pool = SessionPool(CFG, n_slots=1, device="cpu")
        orig = pool.step_blocks_pipelined
        calls = {"n": 0}

        def flaky(blocks):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device fault")
            return orig(blocks)

        pool.step_blocks_pipelined = flaky
        srv, server, port, batcher = await _serve(pool)
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}") as client:
                n = json.loads(await client.recv())["blocksize"]
                blk = (0.1 * np.random.default_rng(0).standard_normal(n)).tolist()
                await client.send(json.dumps({"command": "stream_block", "audio": blk}))
                with pytest.raises(asyncio.TimeoutError):
                    await asyncio.wait_for(client.recv(), 2)
                await client.send(json.dumps({"command": "stream_block", "audio": blk}))
                msg = json.loads(await asyncio.wait_for(client.recv(), 30))
                assert msg["type"] == "processed_block" and len(msg["output"]) == n
        finally:
            await _stop(server, batcher)
        assert calls["n"] >= 2

    asyncio.run(scenario())


def test_pool_with_parallel_branch_chain():
    """The pool takes the parallel container with lifted branch params; a
    session's branch-gain update routes through the batched targets."""
    pytest.importorskip("websockets")
    par_cfg = [{
        "effect_id": "p", "type": "parallel",
        "branches": [
            [{"effect_id": "bf", "type": "filter",
              "params": {"filter_type": 0, "cutoff_hz": 8000, "q": 0.707}}],
            [{"effect_id": "bd", "type": "delay",
              "params": {"delay_ms": 100, "feedback": 0.1, "mix_dry": 0.0, "mix_wet": 1.0}}],
        ],
        "params": {},
    }]

    async def scenario():
        import websockets as ws

        pool = SessionPool(par_cfg, n_slots=1, device="cpu")
        srv, server, port, batcher = await _serve(pool)
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}") as client:
                n = json.loads(await client.recv())["blocksize"]

                async def rms(n_blocks=30):
                    vals = []
                    for _ in range(n_blocks):
                        await client.send(json.dumps({"command": "stream_block",
                                                      "audio": _tone(n, 1000).tolist()}))
                        msg = json.loads(await asyncio.wait_for(client.recv(), 60))
                        assert msg["type"] == "processed_block"
                        vals.append(np.sqrt(np.mean(np.square(msg["output"]))))
                    return float(np.mean(vals[n_blocks // 2:]))

                loud = await rms()
                for param in ("gain_0", "gain_1"):
                    await client.send(json.dumps({"command": "update_param", "effect_id": "p",
                                                  "param": param, "value": 0.0}))
                quiet = await rms()
                assert quiet < loud * 0.2, (loud, quiet)
        finally:
            await _stop(server, batcher)

    asyncio.run(scenario())


def test_pool_pipelined_bit_parity_and_flush():
    """The depth-1 pipelined step: results arrive one step late, BITWISE
    equal to the synchronous path, an idle flush returns the in-flight
    batch, and sync and pipelined calls must not interleave."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.7}},
           {"effect_id": "f", "type": "filter",
            "params": {"filter_type": 0, "cutoff_hz": 3000, "q": 0.8}}]
    pa = SessionPool(cfg, n_slots=4, device="cpu")
    pb = SessionPool(cfg, n_slots=4, device="cpu")
    for p in (pa, pb):
        p.update_param(1, "f", "cutoff_hz", 500)
    rng = np.random.default_rng(7)
    blocks_seq = [{s: rng.standard_normal(N).astype(np.float32) * 0.2 for s in (0, 1, 3)}
                  for _ in range(6)]
    sync_outs = [pa.step_blocks(dict(b)) for b in blocks_seq]
    assert pb.step_blocks_pipelined(dict(blocks_seq[0])) is None
    pipe_outs = [pb.step_blocks_pipelined(dict(b)) for b in blocks_seq[1:]]
    pipe_outs.append(pb.flush_pipeline())
    assert pb.flush_pipeline() is None
    for k, (sy, pi) in enumerate(zip(sync_outs, pipe_outs)):
        assert set(sy) == set(pi) == {0, 1, 3}
        for s in sy:
            np.testing.assert_array_equal(sy[s], pi[s], err_msg=f"{(k, s)}")
    pb.step_blocks_pipelined(dict(blocks_seq[0]))
    with pytest.raises(RuntimeError, match="in flight"):
        pb.step_blocks(dict(blocks_seq[0]))
    pb.drop_pipeline()


def test_pool_release_reclaim_and_step_fault():
    """A released slot comes back FRESH (state reset queued at release,
    applied at the next step: bit-equal to a slot that never streamed), a
    step that raises leaves the pool serving, and per-slot params stay
    divergent through the churn."""
    cfg = [{"effect_id": "f", "type": "filter",
            "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
           {"effect_id": "d", "type": "delay",
            "params": {"delay_ms": 50, "feedback": 0.4, "mix_dry": 0.6, "mix_wet": 0.8,
                       "offset_ms": 5}}]
    pool = SessionPool(cfg, n_slots=4, device="cpu")
    ref = SessionPool(cfg, n_slots=4, device="cpu")
    rng = np.random.default_rng(1)
    sig = [rng.standard_normal(N).astype(np.float32) * 0.2 for _ in range(8)]
    slots = [pool.claim() for _ in range(3)]
    pool.update_param(slots[1], "f", "cutoff_hz", 400)
    pool.update_param(slots[2], "f", "cutoff_hz", 800)
    for k in range(3):
        pool.step_blocks({s: sig[k] for s in slots})
    pool.release(slots[1])
    while pool.claim() != slots[1]:
        pass
    for k in range(3):  # the reference's slot 3 has never streamed
        ref.step_blocks({})
    for k in range(3, 5):
        out = pool.step_blocks({s: sig[k] for s in slots})
        want = ref.step_blocks({3: sig[k]})[3]
        np.testing.assert_array_equal(out[slots[1]], want)
    assert not np.allclose(out[slots[0]], out[slots[2]])

    def boom(*a, **k):
        raise RuntimeError("injected fault")

    pool._step = boom
    with pytest.raises(RuntimeError, match="injected"):
        pool.step_blocks({0: sig[5]})
    del pool._step
    assert np.all(np.isfinite(pool.step_blocks({s: sig[6] for s in slots})[slots[0]]))


def test_pool_discard_frees_without_gc():
    """A discarded SessionPool frees under refcounting ALONE: the serving
    process runs gc.disable(), so any self-referencing cycle would leak the
    pool and its device state on every rebuild."""
    pool = SessionPool(CFG, n_slots=2, device="cpu")
    pool.step_blocks({0: _tone(N, 1000)})
    wp = weakref.ref(pool)
    wc = weakref.ref(pool.chain)
    gc.collect()
    gc.disable()
    try:
        pool.close()
        del pool
        assert wp() is None, "SessionPool kept alive by a cycle"
        assert wc() is None, "chain kept alive after close()"
    finally:
        gc.enable()


@pytest.mark.parametrize("path", ["flush", "pipelined"])
def test_pool_readback_failure_resets_state(path):
    """A step's fault surfaces at the READBACK of its output (on the card,
    the event wait), after self.state was replaced by the failed step's
    output: both readback paths drop the in-flight generation and reset the
    state unconditionally, and the pool keeps serving."""
    def boom():
        raise RuntimeError("poisoned async result")

    pool = SessionPool(CFG, n_slots=2, device="cpu")
    resets = []
    orig = pool._fresh_batched_state
    pool._fresh_batched_state = lambda: (resets.append(1), orig())[1]
    pool._inflight = (boom, (0,))
    with pytest.raises(RuntimeError, match="poisoned"):
        if path == "flush":
            pool.flush_pipeline()
        else:
            pool.step_blocks_pipelined({0: _tone(N, 1000)})
    assert resets, f"{path}: no state reset on readback failure"
    assert pool._inflight is None
    assert np.all(np.isfinite(pool.step_blocks({0: _tone(N, 1000)})[0]))
    pool.close()
