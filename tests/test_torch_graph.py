"""The captured step on the card: the engine's, the pool's and
``ShardedStreams``' CUDA graph replays against the eager step on the same
card (or cards), bit for bit.  Needs a
CUDA device and nvcc; skipped elsewhere.  Imports no JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py
"""

import gc
import json
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
FS, N = 48000, 256
BLOCKS, CHANGE_AT = 40, 20
POOL_SLOTS = 16


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aefs_tpu_torch.ops.kernels import library

    library()  # builds csrc/*.cu on first use
    return torch.device("cuda")


def _presets():
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.engine.flagship import FLAGSHIP

    return {"flagship": FLAGSHIP, **DEFAULT_PRESETS}


# Each chain of the captured step, with the update_param made at block 20.
CHAINS = {
    "flagship": ("o", "semitones", -7.0),
    "Lush Chorus": ("lc1", "rate_hz", 2.5),
    "Rain Delay": ("rd1", "feedback", 0.6),
    "Multiband Master": ("mml", "drive_db", 6.0),
    "Concert Hall (Convolution)": ("cv1", "mix_wet", 0.9),
    "Clean Noise Removal": ("p6", "threshold_db", -30.0),
    "Jet Flanger": ("jf1", "feedback", -0.5),
}
# Where a library op picks another algorithm under capture, the op and the
# bar it is held to instead of bitwise equality (none measured so far).
LIBRARY_OPS = {}


def _blocks(seed, n=BLOCKS, shape=(N, 1)):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _err_dbfs(a, b):
    e = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    return -np.inf if e == 0 else 20.0 * np.log10(e)


def _held(name, got, want):
    if name in LIBRARY_OPS:
        op, bar = LIBRARY_OPS[name]
        assert _err_dbfs(got, want) <= bar, (name, op, _err_dbfs(got, want))
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _eager_stream(cfg, blocks, change, device):
    """The blocks through ``chain.process_block`` on ``device``, the
    targets changed at block CHANGE_AT: the eager reference."""
    from aefs_tpu_torch.core.chain import build_chain

    chain, state, tmap = build_chain(cfg, FS, N, channels_in=1, channels_out=2, device=device)
    targets, outs = chain.targets(tmap), []
    for k, b in enumerate(blocks):
        if k == CHANGE_AT:
            eid, param, value = change
            tmap[eid][param] = value
            targets = chain.targets(tmap)
        state, y = chain.process_block(state, targets,
                                       torch.from_numpy(b.T.copy()).to(device))
        outs.append(y.cpu().numpy().T)
    return np.concatenate(outs)


def _engine_stream(cfg, blocks, change, device, pipelined=False):
    from aefs_tpu_torch.engine.engine import AudioEngine

    eng = AudioEngine(device=device)
    eng.build_chain(cfg)
    step = eng.process_stream_block_pipelined if pipelined else eng.process_stream_block
    outs = []
    for k, b in enumerate(blocks):
        if k == CHANGE_AT:
            eng.update_param(*change)
        outs.append(step(b))
    eng.close()
    return np.concatenate(outs)


@pytest.mark.parametrize("name", list(CHAINS))
def test_engine_graph_matches_eager_step(dev, name):
    """40 blocks through the engine (one graph replay each, an update_param
    at block 20 written into the static targets) against the eager step on
    the card; K1, K3 and K6 credited once per replay."""
    from aefs_tpu_torch.ops.kernels.flanger import flanger_file
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    cfg = _presets()[name]
    blocks = _blocks(11)
    want = _eager_stream(cfg, blocks, CHAINS[name], dev)
    counters = (octaver_step, chorus_step, flanger_file)
    before = [f.launches for f in counters]
    got = _engine_stream(cfg, blocks, CHAINS[name], dev)
    k1, k3, k6 = (f.launches - b for f, b in zip(counters, before))
    assert np.all(np.isfinite(got))
    _held(name, got, want)
    types = [c["type"] for c in cfg]
    assert k1 == (BLOCKS if "octaver" in types else 0)
    assert k3 == (BLOCKS if "chorus" in types else 0)
    assert k6 == (BLOCKS if "flanger" in types else 0)


def test_engine_pipelined_graph_is_sync_shifted(dev):
    blocks = _blocks(5)
    cfg = _presets()["flagship"]
    sync = _engine_stream(cfg, blocks, CHAINS["flagship"], dev)
    pipe = _engine_stream(cfg, blocks, CHAINS["flagship"], dev, pipelined=True)
    np.testing.assert_array_equal(pipe[:N], 0.0)
    np.testing.assert_array_equal(pipe[N:], sync[:-N])


def test_step_runner_replays_what_it_captured(dev):
    """The chain's runner on the card: one graph, the state groups carried
    in place, ``unpack_state`` copies; file_fn replays it block by block,
    bit-equal to the eager steps."""
    from aefs_tpu_torch.core.chain import build_chain

    cfg = _presets()["flagship"]
    chain, state, tmap = build_chain(cfg, FS, N, channels_in=1, device=dev)
    targets = chain.targets(tmap)
    blocks = _blocks(3, 12)
    x = torch.from_numpy(np.stack([b.T for b in blocks])).to(dev)
    fresh = chain.warmup(state, targets)
    runner = chain.packed_step()
    assert runner.graph is not None
    st, ys = chain.file_fn(len(blocks))(fresh, targets, x)
    ref = chain.init_state()
    for k in range(len(blocks)):
        ref, y = chain.process_block(ref, targets, x[k])
        assert torch.equal(ys[k], y), k
    from aefs_tpu_torch.core.convert import flatten_like_jax

    for a, b in zip(flatten_like_jax(st), flatten_like_jax(ref)):
        assert torch.equal(a, b)
    chain.release()
    assert not chain._runners


def test_the_capture_span(dev):
    """``capture_s`` is the tracer's ``chain.capture`` span and a capture
    counts in ``chain.captures``; a capture with the tracer disabled is
    made the same way and still takes its seconds."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.utils.metrics import TRACER

    TRACER.reset()
    TRACER.enable()
    chain = None
    try:
        chain, state, tmap = build_chain(_presets()["flagship"], FS, N, channels_in=1,
                                         device=dev)
        chain.warmup(state, chain.targets(tmap))
        runner = chain.packed_step()
        ex = TRACER.export()
        (_label, t0, t1), = ex["spans"]["chain.capture"]
        assert runner.capture_s == (t1 - t0) / 1e9
        assert ex["counters"]["chain.captures"] == 1
        chain.release()
        TRACER.disable()
        runner = chain.packed_step()
        runner.run()
        assert runner.graph is not None and runner.capture_s > 0
    finally:
        TRACER.disable()
        TRACER.reset()
        if chain is not None:
            chain.release()


def _pool_reference(pool, chain, steps):
    """Replays ``steps`` [(blocks, resets)] through ``chain.process_block``
    eagerly at the pool's width, with the pool's own target buffer
    snapshots: the eager counterpart of the pool's step."""
    state = chain.batch_state(pool._fresh_single, pool.n_slots)
    outs = []
    for blocks, resets, tbuf in steps:
        for slot in resets:
            state = chain.graft_slot_state(state, pool._fresh_single, slot)
        tflat = torch.from_numpy(tbuf).to(chain.device)
        targets = tuple({name: tflat[pool._trows[(i, name)]] for name in model.PARAMS}
                        for i, (eid, model) in enumerate(chain.effects))
        x = np.zeros((pool.n_slots, 1, N), np.float32)
        for s, b in blocks.items():
            x[s, 0] = b
        state, y = chain.process_block(state, targets, torch.from_numpy(x).to(chain.device))
        outs.append(y.cpu().numpy())
    return outs


# The pool's chain and the update_param at step 20 for each mode.
POOL_CHAINS = {"flagship": ("f", "cutoff_hz", 900.0), "Jet Flanger": ("jf1", "feedback", -0.5)}


@pytest.mark.parametrize("mode", ["generic", "grid", "shard4", "jet"])
def test_pool_graph_matches_eager_step(dev, mode, monkeypatch):
    """The flagship pool at 16 slots, 40 steps through a release, a claim
    and an update_param at step 20, against the eager batched step on the
    card; ``shard4`` is four shards on the one card (one graph each);
    ``jet`` is "Jet Flanger"'s pool, one slot's feedback its own from step
    20 (K6 with a feedback a slot)."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.parallel import mesh
    from aefs_tpu_torch.server.pool import SessionPool, grid_static_overrides

    name = "Jet Flanger" if mode == "jet" else "flagship"
    cfg = _presets()[name]
    if mode == "shard4":
        monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [dev] * 4)
    pool = SessionPool(cfg, n_slots=POOL_SLOTS, grid=mode == "grid",
                       shard=mode == "shard4", device=dev)
    assert len(pool._runners) == (4 if mode == "shard4" else 1)
    assert all(r.graph is not None for r in pool._runners)
    chain = build_chain(cfg, FS, N, channels_in=1, channels_out=2, device=dev,
                        static_overrides=grid_static_overrides(cfg) if mode == "grid"
                        else None)[0]
    rng = np.random.default_rng(2)
    slots = [pool.claim() for _ in range(12)]
    steps, got = [], []
    for k in range(BLOCKS):
        resets = []
        if k == CHANGE_AT:
            pool.release(slots[3])
            assert pool.claim() is not None
            resets = [slots[3]]
            pool.update_param(slots[5], *POOL_CHAINS[name])
        blocks = {s: (0.3 * rng.standard_normal(N)).astype(np.float32) for s in slots}
        tbuf = pool._tbuf.copy()
        out = pool.step_blocks(blocks)
        got.append(np.stack([out[s].T for s in slots]))
        steps.append((blocks, resets, tbuf))
    want = _pool_reference(pool, chain, steps)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w[slots], err_msg=f"step {k}")
    pool.close()


def test_rebuilds_keep_card_memory_level(dev):
    """30 rebuilds with gc disabled: each superseded chain (its runner, graph
    and graph memory pool) is freed by refcounting alone, so the card's
    allocated memory after every rebuild is what it was after the first."""
    from aefs_tpu_torch.engine.engine import AudioEngine

    cfg = _presets()["flagship"]
    block = _blocks(1, 1)[0]
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        eng = AudioEngine(device=dev)
        refs, allocated = [], []
        for _ in range(30):
            eng.build_chain(cfg)
            refs.append(weakref.ref(eng.chain))
            eng.process_stream_block(block)
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated(dev))
        alive = sum(r() is not None for r in refs)
        assert alive == 1, f"{alive}/30 chains alive"
        assert max(allocated[1:]) <= allocated[0], allocated
        eng.close()
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


def test_capture_beside_other_threads_card_work(dev):
    """Captures are thread-local: while one thread rebuilds (warms up and
    captures) chain after chain, another keeps stepping a second engine's
    graph and running the plot analysis on the card, as the backend's
    stream thread and plot pump do; neither fails, and the stepped stream
    stays bit-equal to the same blocks without the rebuilds."""
    import threading

    from aefs_tpu_torch.engine.engine import AudioEngine
    from aefs_tpu_torch.utils.analysis import PlotAnalyzer

    cfg = _presets()["flagship"]
    blocks = _blocks(9, 60)
    ref = AudioEngine(device=dev)
    ref.build_chain(cfg)
    want = [ref.process_stream_block(b) for b in blocks]
    ref.close()
    eng = AudioEngine(device=dev)
    eng.build_chain(cfg)
    analyzer = PlotAnalyzer(FS, device=dev)
    got, errors, done = [], [], threading.Event()

    def stream():
        try:
            for b in blocks:
                out = eng.process_stream_block(b)
                analyzer.update(b[:, 0], out.mean(axis=1))
                got.append(out)
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=stream)
    t.start()
    other = AudioEngine(device=dev)
    rebuilds = 0
    while not done.is_set() or rebuilds < 3:
        other.build_chain(_presets()["Lush Chorus" if rebuilds % 2 else "flagship"])
        rebuilds += 1
    t.join()
    other.close()
    eng.close()
    assert not errors, errors
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"block {k}")


def test_rebuild_beside_the_same_engines_stream(dev):
    """One thread rebuilds the engine (a new chain, warmed up and captured,
    the old one released) over and over while another steps that same
    engine, synchronous then pipelined: every block comes back, in order,
    finite and of its shape, and K1 is credited exactly once per block (a
    release landing inside a step would replay no graph, hand back no
    output or credit an empty record)."""
    import threading

    from aefs_tpu_torch.engine.engine import AudioEngine
    from aefs_tpu_torch.ops.kernels.resample import octaver_step

    cfg = _presets()["flagship"]
    blocks = _blocks(13, 120)
    eng = AudioEngine(device=dev)
    eng.build_chain(cfg)
    got, errors, done = [], [], threading.Event()

    def stream():
        try:
            for k, b in enumerate(blocks):
                step = (eng.process_stream_block if k < len(blocks) // 2
                        else eng.process_stream_block_pipelined)
                got.append((k, step(b)))
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            done.set()

    k1 = octaver_step.launches
    t = threading.Thread(target=stream)
    t.start()
    rebuilds = 0
    while not done.is_set() or rebuilds < 3:
        eng.build_chain(cfg)
        rebuilds += 1
    t.join()
    k1 = octaver_step.launches - k1
    eng.close()
    assert not errors, errors
    assert [k for k, _ in got] == list(range(len(blocks)))
    for k, out in got:
        assert out is not None and out.shape == (N, 2), k
        assert np.all(np.isfinite(out)), k
    assert k1 == len(blocks), (k1, rebuilds)


F6_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.engine.flagship import FLAGSHIP
from aefs_tpu_torch.server.pool import SessionPool

rng = np.random.default_rng(4)
blocks = [(0.3 * rng.standard_normal((256, 1))).astype(np.float32) for _ in range(20)]
pool_blocks = [{s: b[:, 0] for s in range(4)} for b in blocks]

def run(device):
    eng = AudioEngine(device=device)
    eng.build_chain(FLAGSHIP)
    stream = np.concatenate([eng.process_stream_block(b) for b in blocks])
    pool = SessionPool(FLAGSHIP, n_slots=4, device=device)
    outs = [pool.step_blocks(b) for b in pool_blocks]
    return stream, np.stack([np.stack([o[s] for s in range(4)]) for o in outs])

on1 = run("cuda:1")  # cuda:0 current and not yet used
on0 = run("cuda:0")
print(json.dumps({"stream": bool(np.array_equal(on1[0], on0[0])),
                  "pool": bool(np.array_equal(on1[1], on0[1]))}))
"""


def test_entry_points_on_a_second_card(dev):
    """F6: the engine and the pool on cuda:1, in a fresh process with cuda:0
    current and unused, bit-equal to the same runs on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: runs on cuda:1 while cuda:0 is current")
    res = subprocess.run([sys.executable, "-c", F6_SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"stream": True, "pool": True}


# -- ShardedStreams: one captured graph per data shard ----------------------

SHARD_STREAMS = 16
# (preset, per-stream targets, the stream map change at block 20: stream,
# effect id, param, value).
SHARD_CHAINS = {
    "flagship": (True, (5, "o", "semitones", -7.0)),
    "Lush Chorus": (False, (None, "lc1", "rate_hz", 2.5)),
}
MODEL_CHAINS = {
    "reverb": [{"effect_id": "r", "type": "reverb",
                "params": {"rt60_s": 1.5, "damp": 0.3, "pre_delay_ms": 10,
                           "mix_dry": 0.7, "mix_wet": 0.5}}],
    "convreverb": [{"effect_id": "c", "type": "convreverb",
                    "params": {"mix_dry": 0.7, "mix_wet": 0.4},
                    "ir_seconds": 0.4, "partition_multiple": 2}],
}


def _sharded_run(cfg, devices, model_parallel, per_stream, change, eager, blocks, n=N,
                 between=None):
    """``ShardedStreams`` over ``devices``: (y per block, peak per block, the
    joined final state), the targets changed at block CHANGE_AT and
    ``between()`` called before the middle block."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.parallel.mesh import ShardedStreams, make_mesh

    chain, _, tmap = build_chain(cfg, FS, n, channels_in=1, channels_out=2, device=devices[0])
    runner = ShardedStreams(chain, make_mesh(devices=devices, model_parallel=model_parallel),
                            SHARD_STREAMS)
    maps = [{k: dict(v) for k, v in tmap.items()} for _ in range(SHARD_STREAMS)]

    def targets():
        return runner.batch_targets(maps) if per_stream else chain.targets(maps[0])

    state, _ = runner.init_state()
    tg, ys, peaks = targets(), [], []
    for k, x in enumerate(blocks):
        if k == len(blocks) // 2 and between is not None:
            between()
        if k == CHANGE_AT and change is not None:
            stream, eid, param, value = change
            for s in ([stream] if per_stream else range(SHARD_STREAMS)):
                maps[s][eid][param] = value
            tg = targets()
        state, y, peak = runner.run_block(state, tg, x, per_stream_targets=per_stream,
                                          eager=eager)
        ys.append(y.cpu().numpy())
        peaks.append(float(peak))
    joined = state.join()
    runner.release()
    return ys, peaks, joined


def _shard_blocks(seed, n=N, count=BLOCKS):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((SHARD_STREAMS, 1, n))).astype(np.float32)
            for _ in range(count)]


def _same_states(a, b):
    from aefs_tpu_torch.core.convert import flatten_like_jax

    for u, v in zip(flatten_like_jax(a), flatten_like_jax(b)):
        assert torch.equal(u.cpu(), v.cpu())


@pytest.mark.parametrize("name", list(SHARD_CHAINS))
def test_sharded_streams_graph_matches_eager(dev, name):
    """16 streams on four shards of the one card, 40 blocks with a target
    change at block 20: the graph step (one replay per shard) bit-equal to
    the eager step, output, peak and joined state; K1 (flagship) or K3
    ("Lush Chorus") credited once per shard per replay."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    per_stream, change = SHARD_CHAINS[name]
    cfg, blocks = _presets()[name], _shard_blocks(17)
    want = _sharded_run(cfg, [dev] * 4, 1, per_stream, change, True, blocks)
    k1, k3 = octaver_step.launches, chorus_step.launches
    got = _sharded_run(cfg, [dev] * 4, 1, per_stream, change, False, blocks)
    k1, k3 = octaver_step.launches - k1, chorus_step.launches - k3
    assert all(np.all(np.isfinite(y)) for y in got[0])
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} block {k}")
    assert got[1] == want[1]
    _same_states(got[2], want[2])
    types = [c["type"] for c in cfg]
    assert k1 == (4 * BLOCKS if "octaver" in types else 0)
    assert k3 == (4 * BLOCKS if "chorus" in types else 0)


@pytest.mark.parametrize("name", list(MODEL_CHAINS))
def test_sharded_model_mesh_graph_matches_eager(dev, name):
    """A (2, 2) mesh on the one card (the reverb's comb bank, the
    convolution reverb's partition history split as ``ModelShards``), 20
    blocks of 512: the graph step bit-equal to the eager step."""
    blocks = _shard_blocks(23, n=512, count=20)
    cfg = MODEL_CHAINS[name]
    want = _sharded_run(cfg, [dev] * 4, 2, False, None, True, blocks, n=512)
    got = _sharded_run(cfg, [dev] * 4, 2, False, None, False, blocks, n=512)
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} block {k}")
    _same_states(got[2], want[2])


def test_sharded_streams_across_cards(dev):
    """Shards whose rows span cards: the flagship over a (2, 1) mesh of
    cuda:0 and cuda:1, and the reverb and the convolution reverb over a
    (2, 2) mesh of four cards (on two: a (1, 2) mesh), each row one capture
    across its cards; the allocator's cache emptied mid-run (as every new
    capture does), which must leave the graphs' side-card memory alone.
    Each bit-equal to its eager step."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA cards: a mesh row across cuda:0 and cuda:1")
    cards = [torch.device("cuda", i) for i in range(4 if count >= 4 else 2)]
    runs = [(_presets()["flagship"], cards[:2], 1, True, SHARD_CHAINS["flagship"][1],
             _shard_blocks(29, count=20), N)]
    runs += [(cfg, cards, 2, False, None, _shard_blocks(31, n=512, count=20), 512)
             for cfg in MODEL_CHAINS.values()]
    for cfg, devices, m, per_stream, change, xs, n in runs:
        want = _sharded_run(cfg, devices, m, per_stream, change, True, xs, n=n)
        got = _sharded_run(cfg, devices, m, per_stream, change, False, xs, n=n,
                           between=torch.cuda.empty_cache)
        for k, (g, w) in enumerate(zip(got[0], want[0])):
            np.testing.assert_array_equal(
                g, w, err_msg=f"{cfg[0]['type']} over {len(devices)} cards, block {k}")
        _same_states(got[2], want[2])


def test_sharded_rebuilds_keep_card_memory_level(dev):
    """20 ``ShardedStreams`` of the flagship over four shards of the card,
    each stepped (capturing four graphs) and dropped with gc disabled: the
    card's allocated memory after each is what it was after the first."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.parallel.mesh import ShardedStreams, make_mesh

    chain, _, tmap = build_chain(_presets()["flagship"], FS, N, channels_in=1, device=dev)
    targets = chain.targets(tmap)
    x = _shard_blocks(3, count=1)[0]
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        refs, allocated = [], []
        for _ in range(20):
            runner = ShardedStreams(chain, make_mesh(devices=[dev] * 4), SHARD_STREAMS)
            state, _ = runner.init_state()
            runner.run_block(state, targets, x)
            refs.append(weakref.ref(runner))
            del runner, state
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated(dev))
        assert all(r() is None for r in refs), "a ShardedStreams outlived its last reference"
        assert max(allocated[1:]) <= allocated[0], allocated
    finally:
        if was:
            gc.enable()
