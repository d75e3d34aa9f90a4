"""Packed state and the step runner (core/packing.py) on the CPU against the
JAX package's packing (aefs_tpu/core/packing.py, tests/test_packing.py):
the same groups from the same state (count, dtypes, sizes and flat
contents, across packages both ways), the runner's step bit-equal to the
eager step and within -90 dBFS of JAX's packed step, the engine and the
pool through the runner bit-equal to ``chain.process_block``, superseded
chains freed with gc disabled, and every preset's step free of the host
reads and uploads a captured CUDA graph cannot hold."""

import copy
import gc
import traceback
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.packing import HybridPacker as JaxHybridPacker
from aefs_tpu.core.packing import Packer as JaxPacker
from aefs_tpu.core.packing import PackedRunner as JaxPackedRunner
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.core.convert import (
    flatten_like_jax, groups_from_numpy, groups_to_numpy, state_from_numpy, state_to_numpy)
from aefs_tpu_torch.core.fileopts import file_static_overrides
from aefs_tpu_torch.core.packing import HybridPacker, PackedRunner, Packer
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.server.pool import SessionPool
from __graft_entry__ import FLAGSHIP

from oracles import err_dbfs

FS = 48000
N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_same_groups(port_groups, jax_groups, exact=True):
    """Same count, dtypes, sizes and flat contents (``exact``: bitwise; else
    integers exact and floats within -90 dBFS)."""
    assert len(port_groups) == len(jax_groups)
    for p, j in zip(groups_to_numpy(port_groups), jax_groups):
        j = np.asarray(j)
        assert p.dtype == j.dtype and p.shape == j.shape, (p.dtype, p.shape, j.dtype, j.shape)
        if exact or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(p, j)
        elif p.size:
            assert err_dbfs(p, j) <= -90, err_dbfs(p, j)


def test_packer_roundtrip_mixed_dtypes():
    """tests/test_packing.py's mixed tree: two groups (float32, int32) whose
    contents equal JAX's, and the round trip keeps every leaf."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.int32(7),
            "c": (np.float32(1.5), np.ones((4,), np.float32))}
    port = state_from_numpy(tree, "cpu")
    p = Packer(port)
    groups = p.pack(port)
    assert len(groups) == 2 and p.n_groups == 2  # f32 + i32
    jp = JaxPacker(jax.tree.map(jnp.asarray, tree))
    _assert_same_groups(groups, jp.pack(jax.tree.map(jnp.asarray, tree)))
    out = p.unpack(groups)
    for a, b in zip(flatten_like_jax(port), flatten_like_jax(out)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name", ["flagship", "8-Bit Arcade", "Concert Hall (Convolution)",
                                  "Multiband Master"])
def test_groups_cross_packages(name):
    """One state, packed by both packages (Packer, and HybridPacker over a
    16-slot batched state whose rings stand alone): the same groups bit
    for bit; JAX's groups load into the port's runner and the port's into
    JAX's, each unpacking to the other's leaves."""
    cfg = FLAGSHIP if name == "flagship" else DEFAULT_PRESETS[name]
    chain, state, tmap = build_chain(cfg, FS, N, channels_in=1, device="cpu")
    jchain, _, _ = jax_build(copy.deepcopy(cfg), FS, N, channels_in=1)
    jstate = jax.tree.map(jnp.asarray, state_to_numpy(state))
    for port_packer, jax_packer, st, jst in (
            (Packer, JaxPacker, state, jstate),
            (HybridPacker, JaxHybridPacker, chain.batch_state(state, 16),
             jax.tree.map(jnp.asarray, state_to_numpy(chain.batch_state(state, 16))))):
        pp, jp = port_packer(st), jax_packer(jst)
        assert pp.n_groups == (jp.n_groups if hasattr(jp, "n_groups") else len(jp.dtypes))
        groups, jgroups = pp.pack(st), jp.pack(jst)
        _assert_same_groups(groups, jgroups)
        # JAX's groups into the port, the port's into JAX.
        back = pp.unpack(groups_from_numpy([np.asarray(g) for g in jgroups], "cpu"))
        for a, b in zip(flatten_like_jax(back), flatten_like_jax(st)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        jback = jp.unpack(tuple(jnp.asarray(g) for g in groups_to_numpy(groups)))
        for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jst)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    runner = chain.packed_step()
    jrunner = jchain.packed_step()
    _assert_same_groups(runner.pack_targets(chain.targets(tmap)),
                        jrunner.pack_targets(jchain.targets(tmap)))


def test_packed_step_matches_plain_step():
    """The chain's runner over 6 blocks: bit-equal to the eager step, the
    state carried identically; its groups and outputs against JAX's
    PackedRunner on the same blocks within -90 dBFS."""
    chain, state, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    targets = chain.targets(tmap)
    runner = chain.packed_step()
    assert chain.step() is runner
    sg = runner.pack_state(chain.init_state())
    tg = runner.pack_targets(targets)
    jchain, jstate, jtmap = jax_build(FLAGSHIP, FS, N, channels_in=1)
    jrunner = jchain.packed_step()
    jsg = jrunner.pack_state(jchain.init_state())
    jtg = jrunner.pack_targets(jchain.targets(jtmap))
    rng = np.random.default_rng(11)
    for i in range(6):
        xb = (0.3 * rng.standard_normal((1, N))).astype(np.float32)
        state, y_ref = chain.process_block(state, targets, torch.from_numpy(xb))
        sg, y_pk = runner(sg, tg, torch.from_numpy(xb))
        assert sg is runner.sgroups  # the static groups, stepped in place
        assert torch.equal(y_ref, y_pk), f"block {i}"
        jsg, jy = jrunner(jsg, jtg, jnp.asarray(xb))
        assert err_dbfs(y_pk.numpy(), np.asarray(jy)) <= -90
    for a, b in zip(flatten_like_jax(state), flatten_like_jax(runner.unpack_state(sg))):
        assert torch.equal(a, b)
    _assert_same_groups(sg, jsg, exact=False)
    # unpack_state hands out copies: the next step does not change them.
    snap = runner.unpack_state()
    before = [t.clone() for t in flatten_like_jax(snap)]
    runner(sg, tg, torch.zeros((1, N)))
    assert all(torch.equal(a, b) for a, b in zip(before, flatten_like_jax(snap)))


def test_packed_batched_step_matches_vmap():
    """A runner over the slot-batched step (S = 3, the targets one value per
    slot, as the pool's are): bit-equal to the eager batched step, within
    -90 dBFS of JAX's runner over its vmapped step (shared targets)."""
    S = 3
    chain, _, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    targets = tuple({k: v.expand(S).clone() for k, v in t.items()}
                    for t in chain.targets(tmap))
    batched = chain.batch_state(chain.init_state(), S)
    runner = PackedRunner(chain.process_block, batched, targets, (S, 1, N))
    sg = runner.pack_state(batched)
    tg = runner.pack_targets(targets)

    jchain, _, jtmap = jax_build(FLAGSHIP, FS, N, channels_in=1)
    jtargets = jchain.targets(jtmap)
    jbatched = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (S,) + l.shape).copy(),
                            jchain.init_state())

    def batched_fn(st, tgt, x):
        return jax.vmap(jchain.process_block, in_axes=(0, None, 0))(st, tgt, x)

    jrunner = JaxPackedRunner(batched_fn, jbatched, jtargets)
    jsg, jtg = jrunner.pack_state(jbatched), jrunner.pack_targets(jtargets)
    st = batched
    rng = np.random.default_rng(5)
    for _ in range(4):
        x = (0.2 * rng.standard_normal((S, 1, N))).astype(np.float32)
        st, y_ref = chain.process_block(st, targets, torch.from_numpy(x))
        sg, y_pk = runner(sg, tg, torch.from_numpy(x))
        assert torch.equal(y_ref, y_pk)
        jsg, jy = jrunner(jsg, jtg, jnp.asarray(x))
        assert err_dbfs(y_pk.numpy(), np.asarray(jy)) <= -90


def test_packed_fast_file_matches_plain():
    """The whole-file pass over a packed state (the port has no whole-file
    graph yet: ``process_whole`` on the runner's unpacked groups) equals
    the plain pass bit for bit, and JAX's packed_fast_file_fn within -90
    dBFS."""
    overrides = file_static_overrides(FLAGSHIP)
    chain, _, tmap = build_chain(FLAGSHIP, FS, 4096, channels_in=1,
                                 static_overrides=overrides, device="cpu")
    targets = chain.targets(tmap)
    x = (0.25 * np.random.default_rng(2).standard_normal((1, 8192))).astype(np.float32)
    _, y_ref = chain.process_whole(chain.init_state(), targets, torch.from_numpy(x))
    packer = Packer(chain.init_state())
    st = packer.unpack(packer.pack(chain.init_state()))
    _, y_pk = chain.process_whole(st, targets, torch.from_numpy(x))
    assert torch.equal(y_ref, y_pk)

    jchain, _, jtmap = jax_build(FLAGSHIP, FS, 4096, channels_in=1,
                                 static_overrides=overrides)
    jrunner = jchain.packed_fast_file_fn()
    _, jy = jrunner(jrunner.pack_state(jchain.init_state()),
                    jrunner.pack_targets(jchain.targets(jtmap)), jnp.asarray(x))
    assert err_dbfs(y_pk.numpy(), np.asarray(jy)) <= -90


def test_runner_repacks_a_passed_through_big_leaf():
    """A step returning a state leaf unchanged, or a view of another one:
    every new group is read before any static one is written."""
    state = {"a": torch.arange(40000, dtype=torch.float32), "b": torch.ones(3),
             "c": torch.zeros(40000)}

    def swap(st, tg, x):
        return {"a": st["c"], "b": st["b"] + 1, "c": st["a"]}, st["b"] * x

    runner = PackedRunner(swap, state, {}, (3,), packer=HybridPacker)
    assert runner.state_packer.n_big == 2
    runner(runner.sgroups, runner.tgroups, torch.ones(3))
    out = runner.unpack_state()
    assert torch.equal(out["a"], torch.zeros(40000))
    assert torch.equal(out["c"], torch.arange(40000, dtype=torch.float32))
    assert torch.equal(out["b"], torch.full((3,), 2.0))


def test_engine_runner_matches_chain_and_jax():
    """40 flagship blocks through the engine (the runner: staging into the
    static x, targets in the static buffer, an update_param at block 20)
    bit-equal to ``chain.process_block``, and within -90 dBFS of JAX's
    engine (its PackedRunner)."""
    from aefs_tpu.engine.engine import AudioEngine as JaxEngine

    rng = np.random.default_rng(8)
    blocks = [(0.3 * rng.standard_normal((N, 1))).astype(np.float32) for _ in range(40)]
    chain, state, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    targets = chain.targets(tmap)
    eng = AudioEngine(device="cpu")
    eng.build_chain(copy.deepcopy(FLAGSHIP))
    jeng = JaxEngine()
    jeng.build_chain(copy.deepcopy(FLAGSHIP))
    got, want, jgot = [], [], []
    for k, b in enumerate(blocks):
        if k == 20:
            tmap["o"]["semitones"] = -7.0
            targets = chain.targets(tmap)
            eng.update_param("o", "semitones", -7.0)
            jeng.update_param("o", "semitones", -7.0)
        state, y = chain.process_block(state, targets, torch.from_numpy(b.T.copy()))
        want.append(y.numpy().T)
        got.append(eng.process_stream_block(b))
        jgot.append(jeng.process_stream_block(b))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert err_dbfs(np.concatenate(got), np.concatenate(jgot)) <= -90
    for a, b in zip(flatten_like_jax(eng.chain_state), flatten_like_jax(state)):
        assert torch.equal(a, b)


def test_pool_runner_matches_chain():
    """The pool's HybridPacker runner over 16 slots bit-equal to the eager
    batched ``chain.process_block`` on the pool's own target snapshots,
    through a release (its reset grafted in place) and an update_param."""
    pool = SessionPool(FLAGSHIP, n_slots=16, device="cpu")
    runner = pool._runners[0]
    assert runner.state_packer.n_big >= 1  # the delay's ring stands alone
    chain = pool.chain
    state = chain.batch_state(pool._fresh_single, 16)
    rng = np.random.default_rng(3)
    for k in range(8):
        resets = []
        if k == 4:
            pool.release(2)
            pool.update_param(5, "f", "cutoff_hz", 900.0)
            resets = [2]
        blocks = {s: (0.3 * rng.standard_normal(N)).astype(np.float32) for s in range(16)}
        tbuf = pool._tbuf.copy()
        out = pool.step_blocks(blocks)
        for s in resets:
            state = chain.graft_slot_state(state, pool._fresh_single, s)
        tflat = torch.from_numpy(tbuf)
        targets = tuple({name: tflat[pool._trows[(i, name)]] for name in model.PARAMS}
                        for i, (eid, model) in enumerate(chain.effects))
        x = torch.from_numpy(np.stack([blocks[s][None] for s in range(16)]))
        state, y = chain.process_block(state, targets, x)
        for s in range(16):
            np.testing.assert_array_equal(out[s], y[s].numpy().T, err_msg=f"{(k, s)}")
    pool.close()


def test_chain_rebuild_frees_under_gc_disable():
    """tests/test_engine.py's guard: the serving processes run with
    gc.disable(), and a rebuild must free the superseded chain by
    refcounting alone; the runner cache (chain -> runner -> bound method ->
    chain) is the cycle ``release`` breaks."""
    cfg_a = [{"effect_id": "f", "type": "filter",
              "params": {"filter_type": 0, "cutoff_hz": 2000, "q": 0.8}}]
    cfg_b = [{"effect_id": "w", "type": "waveshaper",
              "params": {"drive": 4.0, "shape": 1, "mix": 1.0, "out_gain": 1.0}}]
    x = 0.1 * np.random.default_rng(0).standard_normal((N, 1)).astype(np.float32)
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        eng = AudioEngine(device="cpu")
        refs = []
        for i in range(6):
            eng.build_chain(cfg_a if i % 2 == 0 else cfg_b)
            refs.append(weakref.ref(eng.chain))
            eng.process_stream_block(x)
        alive = sum(1 for r in refs if r() is not None)
        assert alive == 1, f"{alive}/6 chains alive under gc.disable()"
        eng.close()
        assert all(r() is None for r in refs), "chain leaked past close()"
    finally:
        if was_enabled:
            gc.enable()


# What a captured step cannot hold: an upload of a host value (torch.tensor,
# from_numpy) or a read of a device value on the host (.item(), float(t),
# a Python branch on a tensor).
HOST_OPS = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense"}


class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in HOST_OPS:
            where = [f for f in traceback.extract_stack() if "aefs_tpu_torch" in f.filename]
            self.hits.append((str(func), f"{where[-1].filename}:{where[-1].lineno}"
                              if where else "?"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["flagship"] + list(DEFAULT_PRESETS))
def test_step_needs_no_host_round_trip(name):
    """Every preset's step (256-sample blocks, single and slot-batched, and
    the 4096-sample superblocks with file statics that
    ``process_array(fast=False)`` and the CLI's checkpointed mode step)
    issues no upload and no host read once warmed up: on the card it runs
    inside a captured CUDA graph, whose warm-up precedes the capture."""
    cfg = FLAGSHIP if name == "flagship" else DEFAULT_PRESETS[name]
    runs = []
    for blocksize, overrides in ((N, None), (4096, file_static_overrides(cfg))):
        chain, state, tmap = build_chain(cfg, FS, blocksize, channels_in=1, device="cpu",
                                         static_overrides=overrides)
        targets = chain.targets(tmap)
        runs.append((chain, state, targets, torch.zeros(1, blocksize)))
        if blocksize == N:
            runs.append((chain, chain.batch_state(state, 2),
                         tuple({k: v.expand(2).clone() for k, v in t.items()} for t in targets),
                         torch.zeros(2, 1, N)))
    for chain, st, tg, x in runs:
        chain.process_block(st, tg, x)  # the warm-up
        mode = _HostOps()
        with mode:
            chain.process_block(st, tg, x)
        assert not mode.hits, (tuple(x.shape), mode.hits)
