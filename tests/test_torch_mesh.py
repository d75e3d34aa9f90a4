"""The mesh layer of the PyTorch port (aefs_tpu_torch/parallel/mesh.py)
against the JAX package's sharded streams on the CPU.

- ``make_mesh`` shapes and JAX's errors; a mesh over two devices is a
  (2, 1) grid, over the visible devices by default (replaced here by four
  host entries, the port's counterpart of JAX's 8 forced host devices);
  without a card the default raises.
- 8 streams on the port's one-device mesh (the slot axis) against JAX's
  ``ShardedStreams`` on its 8-device CPU mesh (4 data x 2 model, the
  configurations of tests/test_parallel.py:30-134), shared and per-stream
  targets: within -90 dBFS, each stream within -120 dBFS of the port's solo
  chain, and the peak meter equal to max |y|.
- The same on (4, 1) and (2, 2) meshes of host entries: within -90 dBFS of
  JAX's mesh; data sharding bit-equal to the one-device runner; the model
  axis (the reverb's comb bank, the convolution reverb's partition
  history, split as ``ModelShards``) within -120 dBFS (reverb) and -100
  dBFS (convolution reverb, and the spectral gate before it) of the solo
  chains, as tests/test_parallel.py holds JAX.
- The flagship's streams bit-equal to a ``SessionPool`` with the same
  per-slot params.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.parallel.mesh import ShardedStreams as JaxStreams
from aefs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.engine.flagship import FLAGSHIP
from aefs_tpu_torch.models.base import ModelShards
from aefs_tpu_torch.parallel import mesh as mesh_mod
from aefs_tpu_torch.parallel.mesh import Mesh, ShardedStreams, make_mesh
from aefs_tpu_torch.server.pool import SessionPool

from oracles import err_dbfs

FS = 48000
S = 8
CHAINS = {
    "filter_delay_reverb": ([
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 2000, "q": 0.707}},
        {"effect_id": "d", "type": "delay",
         "params": {"delay_ms": 375, "feedback": 0.3, "mix_dry": 1.0, "mix_wet": 0.8,
                    "offset_ms": 5}},
        {"effect_id": "r", "type": "reverb",
         "params": {"rt60_s": 1.5, "damp": 0.3, "pre_delay_ms": 10, "mix_dry": 0.7,
                    "mix_wet": 0.5}}], 512),
    "convreverb": ([
        {"effect_id": "c", "type": "convreverb", "params": {"mix_dry": 0.7, "mix_wet": 0.4},
         "ir_seconds": 0.4, "partition_multiple": 2}], 512),
    "spectral_convreverb": ([
        {"effect_id": "s", "type": "spectral",
         "params": {"threshold_db": -50, "reduction": 0.3}},
        {"effect_id": "c", "type": "convreverb", "params": {"mix_dry": 0.7, "mix_wet": 0.4},
         "ir_seconds": 0.4, "partition_multiple": 2}], 512),
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_make_mesh_shapes_and_errors(monkeypatch):
    """One device: the (1, 1) mesh; too few devices and ``n % model_parallel``
    raise JAX's errors word for word; a (2, 1) grid refuses 3 streams with
    JAX's error; two devices make a (2, 1) grid; no card raises."""
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cpu")
    assert make_mesh(1).shape == make_mesh(devices=["cpu"]).shape == mesh.shape
    one = jax.devices()[:1]
    for call in (lambda m, d: m(2, devices=d), lambda m, d: m(model_parallel=2, devices=d)):
        with pytest.raises(ValueError) as info:
            call(make_mesh, ["cpu"])
        assert str(info.value) == _jax_error(lambda: call(jax_make_mesh, one))
    cfg, n = CHAINS["filter_delay_reverb"]
    chain, _, _ = build_chain(cfg, FS, n, device="cpu")
    jchain, _, _ = jax_build(cfg, FS, n, channels_in=1)
    with pytest.raises(ValueError) as info:
        ShardedStreams(chain, Mesh([["cpu"], ["cpu"]]), 3)
    assert str(info.value) == _jax_error(
        lambda: JaxStreams(jchain, jax_make_mesh(2, devices=jax.devices()[:2]), 3))
    two = make_mesh(devices=["cpu", "cpu"])
    assert two.shape == {"data": 2, "model": 1} and two.data_devices == [CPU, CPU]
    if not torch.cuda.is_available():
        monkeypatch.delenv("AEFS_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()


def _stream_maps(cfg):
    """Per-stream targets as tests/test_parallel.py:102-134 sets them."""
    init = {c["effect_id"]: c["params"] for c in cfg}
    maps = []
    for s in range(S):
        m = {k: dict(v) for k, v in init.items()}
        if "f" in m:
            m["f"]["cutoff_hz"] = 500.0 + 400.0 * s
            m["d"]["feedback"] = 0.1 + 0.05 * s
        else:
            m["c"]["mix_wet"] = 0.1 + 0.1 * s
        maps.append(m)
    return init, maps


@pytest.mark.parametrize("name,per_stream", [("filter_delay_reverb", False),
                                             ("filter_delay_reverb", True),
                                             ("convreverb", True)])
def test_sharded_streams_vs_jax(name, per_stream):
    """8 streams, two blocks: the port's one-device mesh against JAX's
    8-device (4 data x 2 model) mesh within -90 dBFS, each stream within
    -120 dBFS of the port's solo chain with its targets, and the peak meter
    max |y| exactly (within -90 dBFS of JAX's)."""
    cfg, n = copy.deepcopy(CHAINS[name])
    init, maps = _stream_maps(cfg)
    chain, _, tmap = build_chain(cfg, FS, n, device="cpu")
    jchain, _, jtmap = jax_build(cfg, FS, n, channels_in=1)
    runner = ShardedStreams(chain, make_mesh(devices=["cpu"]), S)
    jrunner = JaxStreams(jchain, jax_make_mesh(8, model_parallel=2), S)
    state, axes = runner.init_state(init)
    assert axes == chain.state_axes()
    jstate, _ = jrunner.init_state(init)
    targets = runner.batch_targets(maps) if per_stream else chain.targets(tmap)
    jtargets = jrunner.batch_targets(maps) if per_stream else jchain.targets(jtmap)
    rng = np.random.default_rng(5)
    xs = [(0.2 * rng.standard_normal((S, 1, n))).astype(np.float32) for _ in range(2)]
    ys = []
    for x in xs:
        state, y, peak = runner.run_block(state, targets, x, per_stream_targets=per_stream)
        jstate, jy, jpeak = jrunner.run_block(jstate, jtargets, x, per_stream_targets=per_stream)
        assert peak.dim() == 0 and float(peak) == float(y.abs().max()) > 0
        assert err_dbfs(float(peak), float(jpeak)) <= -90
        assert err_dbfs(y.numpy(), np.asarray(jy)) <= -90, err_dbfs(y.numpy(), np.asarray(jy))
        ys.append(y.numpy())
    for s in (0, 3, 6):
        solo, sstate, _ = build_chain(cfg, FS, n, device="cpu")
        tg = solo.targets(maps[s] if per_stream else tmap)
        for b, x in enumerate(xs):
            sstate, r = solo.process_block(sstate, tg, torch.from_numpy(x[s]))
            assert err_dbfs(ys[b][s], r.numpy()) <= -120, (s, b)


def test_sharded_flagship_matches_pool():
    """The flagship's 4 streams with per-stream targets over 6 blocks equal
    a 4-slot ``SessionPool`` given the same params, bit for bit."""
    n_streams, blocks = 4, 6
    chain, _, tmap = build_chain(FLAGSHIP, FS, 256, device="cpu")
    runner = ShardedStreams(chain, make_mesh(devices=["cpu"]), n_streams)
    pool = SessionPool(FLAGSHIP, n_slots=n_streams, device="cpu")
    maps = []
    for s in range(n_streams):
        m = {k: dict(v) for k, v in tmap.items()}
        m["o"]["semitones"] = (-12.0, -7.0, 12.0, 5.0)[s]
        m["f"]["cutoff_hz"] = 1000.0 + 500.0 * s
        for eid, params in m.items():
            for p, v in params.items():
                assert pool.update_param(s, eid, p, v) is None
        maps.append(m)
    state, _ = runner.init_state()
    targets = runner.batch_targets(maps)
    rng = np.random.default_rng(8)
    for _ in range(blocks):
        x = (0.3 * rng.standard_normal((n_streams, 1, 256))).astype(np.float32)
        state, y, peak = runner.run_block(state, targets, x, per_stream_targets=True)
        out = pool.step_blocks({s: x[s, 0] for s in range(n_streams)})
        for s in range(n_streams):
            np.testing.assert_array_equal(y[s].numpy().T, out[s])
        assert float(peak) == float(y.abs().max())


def test_make_mesh_grids_over_visible_devices(monkeypatch):
    """``make_mesh()`` takes every visible device (here four host entries)
    and reshapes them as JAX does: row i holds devices [i*m, (i+1)*m)."""
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda device=None: [CPU] * 4)
    assert make_mesh().shape == {"data": 4, "model": 1}
    assert make_mesh(model_parallel=2).shape == {"data": 2, "model": 2}
    assert make_mesh(2).shape == {"data": 2, "model": 1}
    eight = make_mesh(devices=[f"cpu:{i}" for i in range(8)], model_parallel=2)
    assert eight.shape == dict(jax_make_mesh(8, model_parallel=2).shape)
    assert [[d.index for d in row] for row in eight.devices] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert eight.data_devices == [torch.device("cpu", i) for i in (0, 2, 4, 6)]
    with pytest.raises(ValueError, match="must divide over data axis 4"):
        chain, _, _ = build_chain(CHAINS["convreverb"][0], FS, 512, device="cpu")
        ShardedStreams(chain, make_mesh(), 6)


BLOCKS = 6  # 3072 samples: the reverb's combs (1411-2097 samples) ring
_RUNS = {}


def _inputs():
    rng = np.random.default_rng(5)
    return [(0.2 * rng.standard_normal((S, 1, 512))).astype(np.float32) for _ in range(BLOCKS)]


def _jax_mesh_run(name, per_stream):
    """JAX's (4 data, 2 model) mesh over ``_inputs()``: y per block."""
    key = ("jax", name, per_stream)
    if key not in _RUNS:
        cfg, n = copy.deepcopy(CHAINS[name])
        init, maps = _stream_maps(cfg)
        jchain, _, jtmap = jax_build(cfg, FS, n, channels_in=1)
        runner = JaxStreams(jchain, jax_make_mesh(8, model_parallel=2), S)
        state, _ = runner.init_state(init)
        targets = runner.batch_targets(maps) if per_stream else jchain.targets(jtmap)
        ys = []
        for x in _inputs():
            state, y, _ = runner.run_block(state, targets, x, per_stream_targets=per_stream)
            ys.append(np.asarray(y))
        _RUNS[key] = ys
    return _RUNS[key]


def _port_run(name, per_stream, shape):
    """The port's ShardedStreams on a (data, model) mesh of host entries:
    (y per block, the final state)."""
    cfg, n = copy.deepcopy(CHAINS[name])
    init, maps = _stream_maps(cfg)
    chain, _, tmap = build_chain(cfg, FS, n, device="cpu")
    runner = ShardedStreams(chain, make_mesh(devices=["cpu"] * (shape[0] * shape[1]),
                                             model_parallel=shape[1]), S)
    state, axes = runner.init_state(init)
    assert axes == chain.state_axes() and len(state.shards) == shape[0]
    targets = runner.batch_targets(maps) if per_stream else chain.targets(tmap)
    ys = []
    for x in _inputs():
        state, y, peak = runner.run_block(state, targets, x, per_stream_targets=per_stream)
        assert float(peak) == float(y.abs().max()) > 0
        ys.append(y.numpy())
    return ys, state


def _solo_run(name, per_stream, s):
    key = ("solo", name, per_stream, s)
    if key not in _RUNS:
        cfg, n = copy.deepcopy(CHAINS[name])
        _, maps = _stream_maps(cfg)
        solo, st, tmap = build_chain(cfg, FS, n, device="cpu")
        tg = solo.targets(maps[s] if per_stream else tmap)
        ys = []
        for x in _inputs():
            st, y = solo.process_block(st, tg, torch.from_numpy(x[s]))
            ys.append(y.numpy())
        _RUNS[key] = ys
    return _RUNS[key]


SOLO_BAR = {"filter_delay_reverb": -120, "convreverb": -100, "spectral_convreverb": -100}


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("name,per_stream", [("filter_delay_reverb", False),
                                             ("filter_delay_reverb", True),
                                             ("convreverb", True),
                                             ("spectral_convreverb", False)])
def test_sharded_streams_on_host_meshes(name, per_stream, shape):
    """8 streams over 6 blocks on a (4, 1) or (2, 2) mesh of host entries:
    within -90 dBFS of JAX's (4, 2) mesh (the spectral gate's chain, which
    JAX's CPU mesh runs only through its matmul DFT, against the solo
    chains alone); data sharding bit-equal to the one-device runner; the
    model axis splits the reverb's combs and the convolution reverb's
    history (``ModelShards``) and stays within -120 / -100 dBFS of each
    stream's solo chain."""
    ys, state = _port_run(name, per_stream, shape)
    fx = state.shards[0]["fx"][-1]
    split = fx.get("combs", fx.get("spec_hist"))
    assert isinstance(split, ModelShards) == (shape[1] == 2)
    if shape[1] == 2 and "combs" in fx:
        assert [p.shape[split.axis] for p in split.pieces] == [2, 2]
    if name != "spectral_convreverb":
        for y, jy in zip(ys, _jax_mesh_run(name, per_stream)):
            assert err_dbfs(y, jy) <= -90, err_dbfs(y, jy)
    one, _ = _port_run(name, per_stream, (1, 1))
    for y, y1 in zip(ys, one):
        if shape[1] == 1:
            np.testing.assert_array_equal(y, y1)
        else:
            assert err_dbfs(y, y1) <= SOLO_BAR[name]
    for s in (0, 3, 6):
        for b, r in enumerate(_solo_run(name, per_stream, s)):
            assert err_dbfs(ys[b][s], r) <= SOLO_BAR[name], (s, b, err_dbfs(ys[b][s], r))


def test_sharded_state_joins_to_the_unsharded_state():
    """A (2, 2) mesh's state joins into the one-device runner's state: bit
    for bit with data sharding alone, and the model-split leaves whole
    again."""
    for shape in ((4, 1), (2, 2)):
        _, state = _port_run("filter_delay_reverb", True, shape)
        _, ref = _port_run("filter_delay_reverb", True, (1, 1))
        joined, whole = state.join(), ref.join()
        from aefs_tpu_torch.core.convert import flatten_like_jax

        for a, b in zip(flatten_like_jax(joined), flatten_like_jax(whole)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if shape[1] == 1:
                assert torch.equal(a, b)
            else:
                assert err_dbfs(a.numpy(), b.numpy()) <= -120
