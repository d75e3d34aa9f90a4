"""The one-card mesh layer of the PyTorch port (aefs_tpu_torch/parallel/
mesh.py) against the JAX package's sharded streams on the CPU.

- ``make_mesh`` shapes and JAX's errors on one device; a mesh over two
  devices raises ``NotImplementedError``; without a card the default raises.
- 8 streams on the port's one-device mesh (the slot axis) against JAX's
  ``ShardedStreams`` on its 8-device CPU mesh (4 data x 2 model, the
  configurations of tests/test_parallel.py:30-134), shared and per-stream
  targets: within -90 dBFS, each stream within -120 dBFS of the port's solo
  chain, and the peak meter equal to max |y|.
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
}


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
    JAX's error; two devices are not supported; no card raises."""
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
    with pytest.raises(NotImplementedError, match="one card"):
        make_mesh(devices=["cpu", "cpu"])
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
