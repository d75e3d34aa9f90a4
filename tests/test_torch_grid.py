"""The exact-grid octaver streaming path of the PyTorch port and the pool's
grid serving mode, against the JAX package on the CPU.

- ``gridtaps.octaver_taps_pow2_stream`` against JAX's for every exponent of
  tests/test_gridtaps.py, from the same carried phases: taps within
  -120 dBFS, phasors and the new numerator exact; a leading slot axis equal
  to per-stream calls bit for bit; block-split invariance bit for bit; the
  non-48 kHz rates within -80 dBFS of the float64 oracle.
- The grid ``Octaver`` (phase carried in its state, or locked to the
  ``grid_phase`` param) against JAX's over 40 blocks: within -90 dBFS.
- The grid pool against tests/test_pool.py:481-525: the overrides, the
  warnings (JAX's strings), the shared phase over a release and a claim,
  within -90 dBFS of the JAX grid pool and -120 dBFS of each slot's solo
  chain fed the pool's phase; ``MultiPool`` grid buckets;
  ``canonical_topology(grid=True)`` byte-equal to JAX's.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.ops import gridtaps as jgrid
from aefs_tpu.server.pool import SessionPool as JaxPool
from aefs_tpu.server.pool import canonical_topology as jax_canonical_topology
from aefs_tpu.server.pool import grid_static_overrides as jax_grid_overrides
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.ops import gridtaps
from aefs_tpu_torch.ops.ringbuf import fractional_read_cubic
from aefs_tpu_torch.server.pool import (
    MultiPool, SessionPool, canonical_topology, grid_static_overrides)

from helpers import bursts, mono, tones
from oracles import OracleOctaver, err_dbfs, run_oracle_blocks

FS = 48000
N = 256
SIZE = 1920
OCT = [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.9}},
       {"effect_id": "f", "type": "filter",
        "params": {"filter_type": 0, "cutoff_hz": 3000, "q": 0.8}}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _phase_terms(e, s=SIZE):
    """(modulus, per-sample advance) of the integer phase numerator."""
    return ((1 << -e) * s, (1 << -e) - 1) if e < 0 else (s, -((1 << e) - 1))


@pytest.mark.parametrize("e", [-2, -1, 0, 1, 2])
def test_stream_taps_match_jax(e):
    """From the carried phases tests/test_gridtaps.py uses: the taps within
    -120 dBFS of JAX's (and within 2e-6 of the port's gather read at the
    same exact positions), the phasors and the new numerator exact; all
    the phases in one call with a leading slot axis equal one call each."""
    assert gridtaps.pow2_stream_geometry_ok(SIZE, e, N)
    rng = np.random.default_rng(11 + e)
    hist = rng.standard_normal(SIZE).astype(np.float32)
    x = rng.standard_normal(N).astype(np.float32)
    den, step = _phase_terms(e)
    nums = (0, 1, 7, den // 3, den - 1, den - 3 * abs(step or 1))
    th, tx = torch.from_numpy(hist), torch.from_numpy(x)
    for num0 in nums:
        got = gridtaps.octaver_taps_pow2_stream(th, tx, e, torch.tensor(num0, dtype=torch.int32))
        want = jgrid.octaver_taps_pow2_stream(jnp.asarray(hist), jnp.asarray(x), e,
                                              jnp.int32(num0))
        for g, w in zip(got[:2], want[:2]):
            assert err_dbfs(g.numpy(), np.asarray(w)) <= -120, (num0, err_dbfs(g.numpy(), w))
        for g, w in zip(got[2:4], want[2:4]):
            assert np.array_equal(g.numpy(), np.asarray(w)), num0
        assert got[4].dtype == torch.int32 and int(got[4]) == int(want[4]) == (num0 + N * step) % den
        r1 = (num0 + np.arange(N) * step) % den
        for tap, r in ((got[0], r1), (got[1], (r1 + den // 2) % den)):
            ref = fractional_read_cubic(th, tx, torch.from_numpy((r / (den // SIZE))
                                                                 .astype(np.float32)))
            np.testing.assert_allclose(tap.numpy(), ref.numpy(), rtol=0, atol=2e-6)
    batched = gridtaps.octaver_taps_pow2_stream(
        th.expand(len(nums), SIZE), tx.expand(len(nums), N), e,
        torch.tensor(nums, dtype=torch.int32))
    for k, num0 in enumerate(nums):
        one = gridtaps.octaver_taps_pow2_stream(th, tx, e, torch.tensor(num0))
        for b, o in zip(batched, one):
            assert torch.equal(b[k], o), num0


@pytest.mark.parametrize("e", [-2, -1, 1])
def test_stream_taps_block_split_invariant(e):
    """Blocks of 128, 256 and 512 give bitwise the same taps (the integer
    phase carry is exact), within -120 dBFS of JAX's run."""
    rng = np.random.default_rng(5)
    total = 2048
    sig = rng.standard_normal(total).astype(np.float32)

    def run(bs):
        hist = torch.zeros(SIZE)
        num = torch.zeros((), dtype=torch.int32)
        outs = []
        for k in range(0, total, bs):
            x = torch.from_numpy(sig[k:k + bs])
            s1, s2, p1, p2, num = gridtaps.octaver_taps_pow2_stream(hist, x, e, num)
            outs.append((s1 * (0.5 - 0.5 * torch.cos(2 * np.pi * p1))
                         + s2 * (0.5 - 0.5 * torch.cos(2 * np.pi * p2))).numpy())
            hist = torch.cat([hist, x])[-SIZE:]
        return np.concatenate(outs)

    def run_jax(bs):
        hist, num, outs = jnp.zeros((SIZE,), jnp.float32), jnp.int32(0), []
        for k in range(0, total, bs):
            x = jnp.asarray(sig[k:k + bs])
            s1, s2, p1, p2, num = jgrid.octaver_taps_pow2_stream(hist, x, e, num)
            outs.append(np.asarray(s1 * (0.5 - 0.5 * jnp.cos(2 * np.pi * p1))
                                   + s2 * (0.5 - 0.5 * jnp.cos(2 * np.pi * p2))))
            hist = jnp.concatenate([hist, x])[-SIZE:]
        return np.concatenate(outs)

    ref = run(256)
    np.testing.assert_array_equal(ref, run(128))
    np.testing.assert_array_equal(ref, run(512))
    assert err_dbfs(ref, run_jax(256)) <= -120


@pytest.mark.parametrize("fs,semitones", [(44100, -12), (44100, 12), (32000, -24)])
def test_stream_grid_parity_other_rates(fs, semitones):
    """Exact-grid streaming at non-48 kHz rates: within -80 dBFS of the
    float64 oracle (tests/test_gridtaps.py's bar) and -90 dBFS of JAX."""
    size = max(int(fs * 40.0 / 1000.0), 16)
    assert gridtaps.pow2_stream_geometry_ok(size, gridtaps.pow2_exponent(semitones), 256)
    x = tones(40 * 256, fs=fs)
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": semitones, "mix": 1.0}}]
    statics = {"o": {"grid_semitones": semitones}}
    chain, state, tmap = build_chain(cfg, fs, 256, channels_in=2, static_overrides=statics,
                                     device="cpu")
    assert dict(chain.effects)["o"]._grid_e is not None
    _, got = chain.process_array(state, chain.targets(tmap), x)
    ref = run_oracle_blocks(OracleOctaver(fs, semitones=semitones, mix=1.0),
                            x.astype(np.float64), 256)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)
    jchain, jstate, jtmap = jax_build(cfg, fs, 256, channels_in=2, static_overrides=statics)
    _, jout = jchain.process_array(jstate, jchain.targets(jtmap), x)
    assert err_dbfs(got, jout) <= -90, err_dbfs(got, jout)


@pytest.mark.parametrize("semitones", [-24, -12, 12])
@pytest.mark.parametrize("locked", [False, True], ids=["state_phase", "phase_locked"])
def test_grid_octaver_vs_jax(semitones, locked):
    """The grid octaver over 40 blocks of 256 against JAX's: the same state
    keys and dtypes (``{hist, num}`` or ``{hist}``), outputs within
    -90 dBFS, the carried numerator exact.  Locked, both are fed the phase
    a pool would advance."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": semitones, "mix": 0.8}}]
    statics = {"o": {"grid_semitones": float(semitones), "grid_phase_lock": locked}}
    chain, state, tmap = build_chain(cfg, FS, N, static_overrides=statics, device="cpu")
    jchain, jstate, jtmap = jax_build(cfg, FS, N, channels_in=1, static_overrides=statics)
    model, jmodel = dict(chain.effects)["o"], dict(jchain.effects)["o"]
    assert set(state["fx"][0]) == set(jstate["fx"][0]) == ({"hist"} if locked else {"hist", "num"})
    assert ("grid_phase" in model.PARAMS) == ("grid_phase" in jmodel.PARAMS) == locked
    assert model.grid_phase_advance() == jmodel.grid_phase_advance()
    adv, mod = model.grid_phase_advance()
    x = mono(bursts(40 * N, amp=0.4, seed=31))[:, 0].reshape(40, N)
    phase, got, want = 0, [], []
    for b in range(40):
        if locked:
            tmap["o"]["grid_phase"] = jtmap["o"]["grid_phase"] = float(phase)
            phase = (phase + adv) % mod
        state, y = chain.process_block(state, chain.targets(tmap), torch.from_numpy(x[b][None]))
        jstate, jy = jchain.step()(jstate, jchain.targets(jtmap), jnp.asarray(x[b][None]))
        got.append(y.numpy())
        want.append(np.asarray(jy))
    assert err_dbfs(np.concatenate(got, 1), np.concatenate(want, 1)) <= -90
    if not locked:
        assert state["fx"][0]["num"].dtype == torch.int32
        assert int(state["fx"][0]["num"]) == int(jstate["fx"][0]["num"])


def test_grid_overrides_and_warnings_match_jax():
    """``grid_static_overrides`` equals JAX's; a grid pool refuses live
    ``semitones`` and ``grid_phase`` with JAX's exact warnings, keeps
    ``mix`` live, and a non-octave octaver stays generic."""
    cfgs = [OCT, [{"type": "octaver", "params": {"semitones": 24}}],
            [{"effect_id": "o", "type": "octaver", "params": {"semitones": -7}}]]
    for cfg in cfgs:
        assert grid_static_overrides(cfg) == jax_grid_overrides(cfg)
    pool = SessionPool(OCT, n_slots=2, grid=True, device="cpu")
    jpool = JaxPool(OCT, n_slots=2, grid=True)
    for param, value in (("semitones", -7), ("grid_phase", 7), ("mix", 0.5), ("nope", 1)):
        got = pool.update_param(0, "o", param, value)
        assert got == jpool.update_param(0, "o", param, value), param
    assert "grid-specialized" in pool.update_param(0, "o", "semitones", -7)
    assert "pool-managed" in pool.update_param(0, "o", "grid_phase", 7)
    assert pool.update_param(0, "o", "mix", 0.9) is None
    generic = SessionPool(cfgs[2], n_slots=2, grid=True, device="cpu")
    assert dict(generic.chain.effects)["o"]._grid_e is None and not generic._phase_rows
    jpool.close()


def _solo(phase0, blocks, adv, mod, mix=None):
    """A session's solo grid chain fed the pool's phase from ``phase0``,
    ``mix`` its target when the session set one."""
    chain, state, tmap = build_chain(OCT, FS, N, static_overrides=grid_static_overrides(OCT),
                                     device="cpu")
    if mix is not None:
        tmap["o"]["mix"] = mix
    ys, phase = [], phase0
    for blk in blocks:
        tmap["o"]["grid_phase"] = float(phase)
        state, y = chain.process_block(state, chain.targets(tmap), torch.from_numpy(blk[None]))
        ys.append(y.numpy().T)
        phase = (phase + adv) % mod
    return np.concatenate(ys)


def test_grid_pool_shared_phase_vs_solo_and_jax():
    """A 3-slot grid pool over 12 blocks, slot 2 with its own mix: every
    slot within -120 dBFS of its solo chain fed the pool's grid_phase, and
    within -90 dBFS of JAX's grid pool.  At block 6 slot 1 is released and
    claimed again: its column keeps the shared phase (every column equal,
    never reset to the fresh-slot template), and the new session, fresh
    audio state at the shared phase, matches a solo chain started there."""
    pool = SessionPool(OCT, n_slots=3, grid=True, device="cpu")
    jpool = JaxPool(OCT, n_slots=3, grid=True)
    for p in (pool, jpool):
        assert [p.claim() for _ in range(3)] == [0, 1, 2]
        assert p.update_param(2, "o", "mix", 0.4) is None
    model = dict(pool.chain.effects)["o"]
    adv, mod = model.grid_phase_advance()
    row = next(iter(pool._phase_rows))
    assert list(pool._phase_rows) == list(jpool._phase_rows)
    x = mono(bursts(4 * 12 * N, amp=0.4, seed=41))[:, 0].reshape(4, 12, N)
    got, want = [], []
    for b in range(12):
        if b == 6:
            for p in (pool, jpool):
                p.release(1)
                assert p.claim() == 1
            assert np.all(pool._tbuf[row] == (6 * adv) % mod)
            assert np.all(pool._tbuf[row] == pool._tbuf[row, 0])
        blocks = {s: x[s if not (s == 1 and b >= 6) else 3, b] for s in range(3)}
        got.append(pool.step_blocks(blocks))
        want.append(jpool.step_blocks(blocks))
    assert pool._tbuf[row, 0] == jpool._tbuf[row, 0] == (12 * adv) % mod
    for s in range(3):
        g = np.concatenate([o[s] for o in got])
        w = np.concatenate([o[s] for o in want])
        assert err_dbfs(g, w) <= -90, (s, err_dbfs(g, w))
    solos = {0: _solo(0, x[0], adv, mod), 2: _solo(0, x[2], adv, mod, mix=0.4)}
    solos[1] = np.concatenate([_solo(0, x[1, :6], adv, mod),
                               _solo((6 * adv) % mod, x[3, 6:], adv, mod)])
    for s, want_s in solos.items():
        g = np.concatenate([o[s] for o in got])
        assert err_dbfs(g, want_s) <= -120, (s, err_dbfs(g, want_s))
    jpool.close()


def test_grid_pool_pipelined_advances_phase():
    """The pipelined step advances the shared phase per dispatch exactly as
    the synchronous one, and stays bit-equal to it."""
    pa = SessionPool(OCT, n_slots=2, grid=True, device="cpu")
    pb = SessionPool(OCT, n_slots=2, grid=True, device="cpu")
    rng = np.random.default_rng(9)
    blocks = [{0: (0.3 * rng.standard_normal(N)).astype(np.float32)} for _ in range(5)]
    sync = [pa.step_blocks(b) for b in blocks]
    assert pb.step_blocks_pipelined(blocks[0]) is None
    pipe = [pb.step_blocks_pipelined(b) for b in blocks[1:]] + [pb.flush_pipeline()]
    for s, p in zip(sync, pipe):
        np.testing.assert_array_equal(s[0], p[0])
    row = next(iter(pa._phase_rows))
    assert np.array_equal(pa._tbuf[row], pb._tbuf[row])


def test_grid_multipool_buckets():
    """A grid MultiPool bakes the ratio into each bucket's chain: a session
    migrating to a new whole-octave topology lands on a grid bucket, one
    building the same topology joins it at its shared phase, and a
    non-octave octaver gets a generic bucket."""
    mp = MultiPool(OCT, n_slots=2, grid=True, device="cpu")
    assert dict(mp.default_pool.chain.effects)["o"]._grid_e == -1
    up = [{"effect_id": "u", "type": "octaver", "params": {"semitones": 12, "mix": 0.5}}]
    key, pool, slot, tmap, single, idmap = mp.build_session(up)
    assert key == jax_canonical_topology(up, grid=True)[0] and pool.grid
    assert dict(pool.chain.effects)["fx0"]._grid_e == 1 and idmap == {"u": "fx0"}
    assert "grid_phase" not in tmap["fx0"]
    pool.step_blocks({slot: np.zeros(N, np.float32)})
    row = next(iter(pool._phase_rows))
    _, pool2, slot2, _, _, _ = mp.build_session(up)
    assert pool2 is pool and slot2 != slot
    assert pool._tbuf[row, slot2] == pool._tbuf[row, slot] != 0
    gen = [{"effect_id": "g", "type": "octaver", "params": {"semitones": 7}}]
    _, pool3, _, _, _, _ = mp.build_session(gen)
    assert dict(pool3.chain.effects)["fx0"]._grid_e is None


GRID_TOPOLOGIES = {
    "oct-12": [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12}}],
    "oct-24-mix": [{"effect_id": "o", "type": "octaver", "params": {"semitones": -24, "mix": 1}}],
    "oct+12-filter": copy.deepcopy(OCT[1:]) + [
        {"type": "octaver", "params": {"semitones": 12.0}}],
    "oct-default": [{"effect_id": "o", "type": "octaver", "params": {}}],
    "oct0": [{"effect_id": "o", "type": "octaver", "params": {"semitones": 0}}],
    "oct-7": [{"effect_id": "o", "type": "octaver", "params": {"semitones": -7}}],
}


@pytest.mark.parametrize("name", list(GRID_TOPOLOGIES))
def test_canonical_topology_grid_matches_jax(name):
    """``canonical_topology(grid=True)`` byte-equal to JAX's: whole-octave
    ratios are baked into the key, other ratios are not."""
    cfg = GRID_TOPOLOGIES[name]
    assert canonical_topology(cfg, grid=True) == jax_canonical_topology(cfg, grid=True)
    baked = "__grid_semitones" in canonical_topology(cfg, grid=True)[0]
    assert baked == (name != "oct-7")


@pytest.mark.parametrize("e", [-2, -1, 0, 1, 2])
def test_file_taps_file_axis_and_jax(e):
    """``octaver_taps_pow2`` (whole file from fresh phase, one gather per
    tap) over three files on a leading axis: bit-equal to one call per
    file, and within -120 dBFS of JAX's per-class slices (phasors exact)."""
    rng = np.random.default_rng(11 + e)
    n = 3 * 4096 + 100
    hist = rng.standard_normal((3, SIZE)).astype(np.float32)
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = gridtaps.octaver_taps_pow2(torch.from_numpy(hist), torch.from_numpy(x), e)
    for f in range(3):
        one = gridtaps.octaver_taps_pow2(torch.from_numpy(hist[f]), torch.from_numpy(x[f]), e)
        assert all(torch.equal(a[f], b) for a, b in zip(got, one)), f
    want = jgrid.octaver_taps_pow2(jnp.asarray(hist[0]), jnp.asarray(x[0]), e)
    for a, b in zip(got[:2], want[:2]):
        assert err_dbfs(a[0].numpy(), b) <= -120, err_dbfs(a[0].numpy(), b)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
