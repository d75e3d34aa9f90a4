"""Parameter glides through the port's step runner (counterpart of
tests/test_fuzz_glides.py and tests/test_smoothing_motion.py, with their
seeds, lengths and oracles): the targets reach the step through the
runner's static target buffer (core/packing.py), as the engine writes
them on ``update_param``.

- random A -> B retargets over each effect's full ParamSpec range stay
  finite and land exactly on clamp(B); A -> A is a bitwise no-op;
- the delay's feedback/time glide and the filter's cutoff glide match
  oracles that replay the reference's per-block smoothing.
"""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.models import EFFECT_REGISTRY

from helpers import bursts, noise, tones
from oracles import OracleBiquad, OracleSmooth, OracleStereoDelay, err_dbfs
from test_fuzz_glides import BLOCKS, GLIDE_TYPES, N, draw_params

FS = 48000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build(cfg, static, channels_in=1):
    return build_chain(cfg, FS, N, channels_in=channels_in,
                       static_overrides={"e": static} if static else None, device="cpu")


@pytest.mark.parametrize("seed", range(len(GLIDE_TYPES)))
def test_random_glide_converges_and_stays_finite(seed):
    rng = np.random.default_rng(2000 + seed)
    etype = GLIDE_TYPES[seed % len(GLIDE_TYPES)]
    cls = EFFECT_REGISTRY[etype]
    a = draw_params(cls, rng)
    b = draw_params(cls, rng, near=a)
    static = {"ir_seconds": 0.4} if etype == "convreverb" else {}
    cfg = [{"effect_id": "e", "type": etype, "params": {**static, **a}}]

    chain, state, _ = _build(cfg, static)
    x = bursts(BLOCKS * N, amp=0.3, seed=seed)
    # process_array(fast=False) writes the B targets into the runner's
    # static target buffer and replays its step block by block.
    state, out = chain.process_array(state, chain.targets({"e": b}), x)
    label = f"{etype} {a} -> {b}"
    assert np.all(np.isfinite(out)), label
    for name, spec in cls.PARAMS.items():
        got = float(state["params"][0][name])
        want = spec.clamp(b[name])
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (
            f"{label}: {name} stuck at {got}, target {want}")

    # A -> A is bitwise a no-op.
    xa = bursts(8 * N, amp=0.3, seed=seed + 1)
    chain2, s2, tmap2 = _build(cfg, static)
    _, ya = chain2.process_array(s2, chain2.targets(tmap2), xa)
    chain3, s3, _ = _build(cfg, static)
    _, yb = chain3.process_array(s3, chain3.targets({"e": dict(a)}), xa)
    np.testing.assert_array_equal(ya, yb, err_msg=label)
    for c in (chain, chain2, chain3):
        c.release()


def _stream(chain, tmap, x, blocks, on_block):
    """``blocks`` blocks through the chain's step runner: ``on_block(i)``
    may retarget ``tmap``, whose packed targets are then written into the
    runner's static target buffer (the engine's ``update_param`` path)."""
    runner = chain.step()
    runner.write_targets(runner.pack_targets(chain.targets(tmap)))
    sg = runner.pack_state(chain.init_state())
    outs = []
    for i in range(blocks):
        if on_block(i):
            runner.write_targets(runner.pack_targets(chain.targets(tmap)))
        sg, y = runner(sg, runner.tgroups, torch.from_numpy(x[i * N:(i + 1) * N].T.copy()))
        outs.append(y.numpy().T)
    return np.concatenate(outs)


def test_delay_feedback_glide_matches_oracle():
    x = noise(60 * N, amp=0.25)
    start = {"delay_ms": 300.0, "feedback": 0.1, "mix_dry": 1.0,
             "mix_wet": 1.0, "offset_ms": 0.0}
    cfg = [{"effect_id": "d", "type": "delay", "params": dict(start)}]
    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")

    def retarget(i):
        if i == 10:
            tmap["d"]["feedback"] = 0.8
        if i == 30:
            tmap["d"]["delay_ms"] = 80.0
        return i in (10, 30)

    got = _stream(chain, tmap, x, 60, retarget)

    # The oracle steps its params like the reference effect (delay.py:82-83),
    # fed a delay_ms that lands on the implementation's float32 integer lag
    # (tests/test_smoothing_motion.py's rationale).
    oracle = OracleStereoDelay(FS, **start)
    fb = OracleSmooth(0.1, 0.0, 0.95)
    dl = OracleSmooth(300.0, 1.0, 1499.0)
    refs = []
    for i in range(60):
        if i == 10:
            fb.set_target(0.8)
        if i == 30:
            dl.set_target(80.0)
        dl.step(1000.0 * 2.0 / FS)
        cur = np.float32(dl.current)
        d_impl = int(np.float32(np.float32(FS) * cur / np.float32(1000.0)))
        oracle.p["delay_ms"] = (d_impl + 0.5) * 1000.0 / FS
        oracle.p["feedback"] = fb.step(0.02)
        refs.append(oracle.process(x[i * N:(i + 1) * N].astype(np.float64)))
    ref = np.concatenate(refs)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_filter_cutoff_glide_matches_oracle():
    # The multiplicative 10%/block glide compounds float32 parameter
    # rounding against the float64 oracle; tests/test_smoothing_motion.py
    # holds JAX to -75 dBFS here.
    x = tones(40 * N, fs=FS)
    start = {"filter_type": 0, "cutoff_hz": 4000.0, "q": 0.707}
    cfg = [{"effect_id": "f", "type": "filter", "params": dict(start)}]
    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")

    def retarget(i):
        if i == 5:
            tmap["f"]["cutoff_hz"] = 400.0
        return i == 5

    got = _stream(chain, tmap, x, 40, retarget)
    oracle = OracleBiquad(FS, **start)
    fc = OracleSmooth(4000.0, 20.0, 20000.0)
    refs = []
    for i in range(40):
        if i == 5:
            fc.set_target(400.0)
        oracle.p["cutoff_hz"] = fc.step(fc.current * 0.1)
        refs.append(oracle.process(x[i * N:(i + 1) * N].astype(np.float64)))
    ref = np.concatenate(refs)
    assert err_dbfs(got, ref) <= -75, err_dbfs(got, ref)
