"""``ShardedStreams``' compiled step (aefs_tpu_torch/parallel/mesh.py) on the
CPU, where each data shard's ``PackedRunner`` runs its step eagerly over
the same static buffers the card's graph replays.

- A warmed sharded step (the flagship on a (4, 1) host mesh, the reverb
  and the convolution reverb on a (2, 2) one, where the model axis splits
  their state as ``ModelShards``) issues no upload and no host read: on
  the card it is one captured graph per shard.
- JAX's donation, as the port keeps it: a state the caller holds is never
  written to, so a held fresh state steps to the same output twice; the
  state a step returns is the runners' static buffers and is stepped in
  place, any other is copied in; ``join()`` copies out; the joined state
  after n steps equals the eager step's; a fresh state passed mid-run
  resets every stream.
- Per-stream targets equal to the shared ones give the shared run bit for
  bit, and distinct ones the eager step's.
"""

import copy

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import flatten_like_jax
from aefs_tpu_torch.core.packing import PackedRunner
from aefs_tpu_torch.engine.flagship import FLAGSHIP
from aefs_tpu_torch.parallel.mesh import ShardedStreams, make_mesh

from test_torch_mesh import CHAINS
from test_torch_packing import _HostOps

FS = 48000
S = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _streams(name, shape):
    """(ShardedStreams on a host mesh of ``shape``, its chain, its targets
    map, the block length)."""
    if name == "flagship":
        cfg, n = FLAGSHIP, 256
    else:
        cfg, n = copy.deepcopy(CHAINS[name])
    chain, _, tmap = build_chain(cfg, FS, n, device="cpu")
    mesh = make_mesh(devices=["cpu"] * (shape[0] * shape[1]), model_parallel=shape[1])
    return ShardedStreams(chain, mesh, S), chain, tmap, n


def _blocks(n, count, seed=3):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((S, 1, n))).astype(np.float32) for _ in range(count)]


def _leaves(state):
    return flatten_like_jax(state.join())


def _same(a, b):
    la, lb = flatten_like_jax(a), flatten_like_jax(b)
    assert len(la) == len(lb)
    return all(torch.equal(u, v) for u, v in zip(la, lb))


@pytest.mark.parametrize("name,shape", [("flagship", (4, 1)),
                                        ("filter_delay_reverb", (2, 2)),
                                        ("convreverb", (2, 2))],
                         ids=["flagship-4x1", "reverb-2x2", "convreverb-2x2"])
def test_warmed_sharded_step_needs_no_host_round_trip(name, shape):
    """Once warmed up, a step from the state the last one returned, with
    per-stream targets and with shared ones, uploads nothing and reads
    nothing back: what each shard's captured graph must hold."""
    runner, chain, tmap, n = _streams(name, shape)
    state, _ = runner.init_state()
    per = runner.batch_targets([tmap] * S)
    shared = chain.targets(tmap)
    x = _blocks(n, 1)[0]
    state, _, _ = runner.run_block(state, per, x, per_stream_targets=True)  # the warm-up
    if shape[1] == 2:
        fx = state.shards[0]["fx"][-1]
        assert type(fx.get("combs", fx.get("spec_hist"))).__name__ == "ModelShards"
    for targets, per_stream in ((per, True), (shared, False)):
        mode = _HostOps()
        with mode:
            state, _, _ = runner.run_block(state, targets, x, per_stream_targets=per_stream)
        assert not mode.hits, (per_stream, mode.hits)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_held_state_is_never_written(shape, monkeypatch):
    """A held fresh state is unchanged after a step, and stepping from it
    twice gives the same output twice; the step it returns is stepped in
    place (no copy in), a held state copied in (one write per shard)."""
    runner, chain, tmap, n = _streams("filter_delay_reverb", shape)
    fresh, _ = runner.init_state()
    before = [t.clone() for t in _leaves(fresh)]
    targets = chain.targets(tmap)
    x = _blocks(n, 1)[0]
    writes = []
    real = PackedRunner.write_state
    monkeypatch.setattr(PackedRunner, "write_state",
                        lambda self, g: (writes.append(self), real(self, g))[1])
    live, y1, p1 = runner.run_block(fresh, targets, x)
    assert len(writes) == shape[0]
    nxt, _, _ = runner.run_block(live, targets, x)
    assert len(writes) == shape[0], "the returned state was copied back in"
    assert all(a is b for a, b in zip(nxt.shards, live.shards))
    _, y2, p2 = runner.run_block(fresh, targets, x)
    assert len(writes) == 2 * shape[0]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(fresh), before))
    assert torch.equal(y1, y2) and float(p1) == float(p2)


def test_joined_state_is_a_copy_and_equals_the_eager_steps():
    """After 5 steps the joined state equals the eager step's bit for bit,
    and the next step leaves it as it was."""
    runner, chain, tmap, n = _streams("filter_delay_reverb", (2, 2))
    targets = runner.batch_targets([tmap] * S)
    xs = _blocks(n, 6)
    state, _ = runner.init_state()
    ref, _ = runner.init_state()
    for x in xs[:5]:
        state, y, _ = runner.run_block(state, targets, x, per_stream_targets=True)
        ref, y_ref, _ = runner.run_block(ref, targets, x, per_stream_targets=True, eager=True)
        assert torch.equal(y, y_ref)
    joined = state.join()
    keep = [t.clone() for t in flatten_like_jax(joined)]
    assert _same(joined, ref.join())
    runner.run_block(state, targets, xs[5], per_stream_targets=True)
    assert all(torch.equal(a, b) for a, b in zip(flatten_like_jax(joined), keep))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_fresh_state_mid_run_resets_every_stream(shape):
    """Three blocks, then a fresh state: the blocks after it equal a run
    begun fresh on them, for every stream."""
    runner, chain, tmap, n = _streams("filter_delay_reverb", shape)
    targets = chain.targets(tmap)
    xs = _blocks(n, 6)
    state, _ = runner.init_state()
    for x in xs[:3]:
        state, _, _ = runner.run_block(state, targets, x)
    state, _ = runner.init_state()
    got = []
    for x in xs[3:]:
        state, y, _ = runner.run_block(state, targets, x)
        got.append(y)
    other, _, _, _ = _streams("filter_delay_reverb", shape)
    fresh, _ = other.init_state()
    for x, y in zip(xs[3:], got):
        fresh, want, _ = other.run_block(fresh, targets, x)
        assert torch.equal(y, want)


def test_per_stream_targets_against_shared_targets():
    """The flagship on a (4, 1) mesh: per-stream targets all equal to the
    shared ones give the shared run bit for bit, from the same runners
    (the modes alternate block by block); distinct per-stream targets,
    changed at block 3, give the eager step's."""
    runner, chain, tmap, n = _streams("flagship", (4, 1))
    xs = _blocks(n, 6, seed=9)
    shared = chain.targets(tmap)
    same = runner.batch_targets([tmap] * S)
    state, _ = runner.init_state()
    ref, _ = runner.init_state()
    for k, x in enumerate(xs):
        per_stream = k % 2 == 1
        state, y, _ = runner.run_block(state, same if per_stream else shared, x,
                                       per_stream_targets=per_stream)
        ref, y_ref, _ = runner.run_block(ref, shared, x, eager=True)
        assert torch.equal(y, y_ref), k
    maps = [{k: dict(v) for k, v in tmap.items()} for _ in range(S)]
    for s in range(S):
        maps[s]["o"]["semitones"] = float(-12 + 3 * s)
    state, _ = runner.init_state()
    ref, _ = runner.init_state()
    targets = runner.batch_targets(maps)
    for k, x in enumerate(xs):
        if k == 3:
            maps[2]["f"]["cutoff_hz"] = 900.0
            targets = runner.batch_targets(maps)
        state, y, peak = runner.run_block(state, targets, x, per_stream_targets=True)
        ref, y_ref, p_ref = runner.run_block(ref, targets, x, per_stream_targets=True,
                                             eager=True)
        assert torch.equal(y, y_ref) and float(peak) == float(p_ref), k


def test_runners_name_their_shard_and_refuse_other_blocks():
    """Each shard's runner is labelled with the chain and the shard (a
    failed capture raises with it); a block of another length raises."""
    runner, chain, tmap, n = _streams("flagship", (4, 1))
    state, _ = runner.init_state()
    runner.run_block(state, chain.targets(tmap), _blocks(n, 1)[0])
    labels = [r.label for r in runner._runners]
    assert all(lbl.startswith(chain.label()) and f"shard {i} of 4" in lbl
               for i, lbl in enumerate(labels)), labels
    with pytest.raises(ValueError, match="the step takes"):
        runner.run_block(state, chain.targets(tmap), _blocks(2 * n, 1)[0])
    runner.release()
    assert runner._runners is None
