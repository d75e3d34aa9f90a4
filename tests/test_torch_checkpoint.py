"""Session checkpoints in the PyTorch port (engine/checkpoint.py,
core/convert.py's JAX-order flattening) against the JAX package.

- ``flatten_like_jax`` gives ``jax.tree.flatten``'s leaf order, path for
  path, on the flagship and all 17 presets.
- A session saved by the JAX engine resumes in the port's CPU engine, and
  one saved by the port resumes in the JAX engine: the flagship,
  "Multiband Master" (90 leaves) and "8-Bit Arcade" (the bitcrusher's and
  ring mod's uint32 accumulators).  The continuation equals, bit for bit,
  the receiving package's continuation from the same state handed over by
  key path, and sits within -90 dBFS of the other package's continuation.
  "Multiband Master" is the stated exception of the port's parity tests
  (tests/test_torch_chain.py): JAX solves its biquads in float32, which at
  the 150 Hz crossover stays only -30 dBFS from the float64 oracle the port
  meets (-42 dBFS on these blocks from the start), so there the bar against
  the other package is that -30 dBFS; the bit-exact handover by key path
  holds there as everywhere.
- Within the port, a resume is bit-exact (mirroring tests/test_checkpoint.py,
  custom IRs and learned noise profiles included), and the format's
  crash-safety rules hold.
"""

import copy
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.engine import checkpoint as jax_ckpt
from aefs_tpu.engine.engine import AudioEngine as JaxEngine
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import (
    flatten_like_jax, state_from_numpy, state_to_numpy, unflatten_like_jax)
from aefs_tpu_torch.engine.checkpoint import (
    ir_static_overrides, load_session, remap_profiles, save_session)
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.engine.wavio import encode_wav_int16
from __graft_entry__ import FLAGSHIP

from helpers import bursts, noise, tones
from oracles import err_dbfs

FS = 48000
N = 256
CFGS = [
    {"effect_id": "d", "type": "delay",
     "params": {"delay_ms": 200, "feedback": 0.5, "mix_dry": 1.0,
                "mix_wet": 0.8, "offset_ms": 10}},
    {"effect_id": "r", "type": "reverb",
     "params": {"rt60_s": 1.5, "damp": 0.3, "pre_delay_ms": 5,
                "mix_dry": 0.7, "mix_wet": 0.5}},
]
CONFIGS = {"flagship": FLAGSHIP, **DEFAULT_PRESETS}
CROSS = ("flagship", "Multiband Master", "8-Bit Arcade")
N_SAVE, N_MORE = 4, 4  # blocks streamed before the save, and after it


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _path_tree(tree, prefix=""):
    """The tree with each leaf replaced by its key path, insertion order kept."""
    if isinstance(tree, dict):
        return {k: _path_tree(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_path_tree(v, f"{prefix}/{i}") for i, v in enumerate(tree))
    return prefix


def _jax_paths(state):
    keys = jax.tree_util.tree_flatten_with_path(state)[0]
    return ["".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}" for k in path)
            for path, _ in keys]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flatten_like_jax_matches_jax_order(name):
    """Leaf i of the port's flattening is leaf i of ``jax.tree.flatten``,
    by key path, shape and dtype; the unflattening restores the tree."""
    cfg = copy.deepcopy(CONFIGS[name])
    _, jstate, _ = jax_build(cfg, FS, N, channels_in=1)
    _, state, _ = build_chain(copy.deepcopy(CONFIGS[name]), FS, N, channels_in=1, device="cpu")
    assert flatten_like_jax(_path_tree(state)) == _jax_paths(jstate)
    jleaves = jax.tree.leaves(jstate)
    leaves = flatten_like_jax(state)
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    assert [t.numpy().dtype for t in leaves] == [np.asarray(a).dtype for a in jleaves]
    back = unflatten_like_jax(state, leaves)
    assert _path_tree(back) == _path_tree(state)
    assert all(a is b for a, b in zip(flatten_like_jax(back), leaves))


def test_unflatten_like_jax_rejects_extra_leaves():
    tree = {"b": torch.zeros(1), "a": (torch.zeros(2),)}
    with pytest.raises(ValueError):
        unflatten_like_jax(tree, flatten_like_jax(tree) + [torch.zeros(1)])


def _cross_blocks():
    x = (tones((N_SAVE + N_MORE) * N, channels=1)
         + bursts((N_SAVE + N_MORE) * N, channels=1, amp=0.2)).astype(np.float32)
    return [x[i * N:(i + 1) * N] for i in range(N_SAVE + N_MORE)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per configuration, the JAX engine streams N_SAVE blocks, saves, and
    streams N_MORE more: (checkpoint path, its continuation)."""
    blocks = _cross_blocks()
    runs = {}
    for name in CROSS:
        eng = JaxEngine()
        eng.build_chain(copy.deepcopy(CONFIGS[name]))
        for b in blocks[:N_SAVE]:
            eng.process_stream_block(b)
        path = eng.save_session(str(tmp_path_factory.mktemp("jax") / "sess"))
        runs[name] = (path, np.concatenate([eng.process_stream_block(b) for b in blocks[N_SAVE:]]))
        eng.close()
    return runs


def _port_stream(eng, blocks):
    return np.concatenate([eng.process_stream_block(b) for b in blocks])


def _hold_to_other_package(name, got, want):
    err = err_dbfs(got, want)
    # "Multiband Master": the stated exception (module docstring).
    assert err <= (-30 if name == "Multiband Master" else -90), err


@pytest.mark.parametrize("name", CROSS)
def test_jax_session_resumes_in_port(name, jax_runs):
    path, want = jax_runs[name]
    blocks = _cross_blocks()[N_SAVE:]
    eng = AudioEngine(device="cpu")
    assert eng.resume_session(path) == CONFIGS[name]
    got = _port_stream(eng, blocks)

    # The same state handed over by key path (core/convert.py), stepped on.
    cfg, _, rebuild, _, _, _ = jax_ckpt.load_session(path)
    _, template, _ = jax_build(cfg, FS, N, channels_in=1)
    jstate = jax.tree.map(np.asarray, rebuild(template))
    ref_eng = AudioEngine(device="cpu")
    ref_eng.build_chain(cfg)
    ref_eng.chain_state = state_from_numpy(jstate, "cpu")
    assert np.array_equal(got, _port_stream(ref_eng, blocks))
    _hold_to_other_package(name, got, want)


@pytest.mark.parametrize("name", CROSS)
def test_port_session_resumes_in_jax(name, tmp_path):
    blocks = _cross_blocks()
    eng = AudioEngine(device="cpu")
    eng.build_chain(copy.deepcopy(CONFIGS[name]))
    _port_stream(eng, blocks[:N_SAVE])
    path = eng.save_session(str(tmp_path / "port"))
    port_tail = _port_stream(eng, blocks[N_SAVE:])

    # The JAX engine resumes the port's checkpoint, and a checkpoint the
    # JAX package wrote itself from the port's state (by key path).
    cfg, tmap, _, _, _, _ = load_session(path)
    twin = AudioEngine(device="cpu")
    twin.resume_session(path)
    jax_ckpt.save_session(str(tmp_path / "by_path"), cfg, tmap,
                          state_to_numpy(twin.chain_state), fs=FS)
    outs = []
    for p in (path, str(tmp_path / "by_path")):
        jeng = JaxEngine()
        assert jeng.resume_session(p) == CONFIGS[name]
        outs.append(np.concatenate([jeng.process_stream_block(b) for b in blocks[N_SAVE:]]))
        jeng.close()
    assert np.array_equal(outs[0], outs[1])
    _hold_to_other_package(name, outs[0], port_tail)


# -- within the port (mirrors tests/test_checkpoint.py) ----------------------

def _chain_steps(chain, state, targets, x, blocks):
    outs = []
    for i in blocks:
        state, y = chain.process_block(state, targets, torch.from_numpy(x[i * N:(i + 1) * N].T.copy()))
        outs.append(y.numpy())
    return state, outs


def test_save_load_resume_bit_exact(tmp_path):
    chain, state, tmap = build_chain(CFGS, FS, N, channels_in=2, device="cpu")
    targets = chain.targets(tmap)
    x = noise(40 * N, amp=0.3)
    state, _ = _chain_steps(chain, state, targets, x, range(20))
    save_session(str(tmp_path / "ckpt"), CFGS, tmap, state)
    _, ref = _chain_steps(chain, state, targets, x, range(20, 40))

    cfgs2, tmap2, rebuild, _, _, _ = load_session(str(tmp_path / "ckpt"))
    assert cfgs2 == CFGS
    chain2, template, _ = build_chain(cfgs2, FS, N, channels_in=2, device="cpu")
    _, got = _chain_steps(chain2, rebuild(template), chain2.targets(tmap2), x, range(20, 40))
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_leaf_mismatch_raises(tmp_path):
    _, state, tmap = build_chain(CFGS, FS, N, channels_in=2, device="cpu")
    save_session(str(tmp_path / "ckpt"), CFGS, tmap, state)
    _, _, rebuild, _, _, _ = load_session(str(tmp_path / "ckpt"))
    _, other, _ = build_chain(CFGS[:1], FS, N, channels_in=2, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        rebuild(other)
    _, other_fs, _ = build_chain(CFGS, 22050, N, channels_in=2, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        rebuild(other_fs)


def test_save_resume_integer_state_effects_bit_exact(tmp_path):
    """uint32 phase accumulators (ring mod, bitcrusher), the flanger's
    history and the limiter's gain state round-trip bitwise, dtypes kept."""
    cfgs = [
        {"effect_id": "b", "type": "bitcrusher",
         "params": {"bits": 6.0, "rate_hz": 11025.0, "mix": 1.0}},
        {"effect_id": "r", "type": "ringmod",
         "params": {"carrier_hz": 4321.0, "mix": 0.7, "spread": 0.25}},
        {"effect_id": "fl", "type": "flanger",
         "params": {"rate_hz": 0.4, "depth_ms": 1.5, "base_ms": 2.0,
                    "feedback": 0.55, "mix": 0.5, "spread": 0.0}},
        {"effect_id": "li", "type": "limiter",
         "params": {"ceiling_db": -3.0, "release_ms": 50.0,
                    "drive_db": 6.0, "lookahead_ms": 2.0}},
    ]
    chain, state, tmap = build_chain(cfgs, FS, N, channels_in=2, device="cpu")
    targets = chain.targets(tmap)
    x = noise(20 * N, amp=0.4)
    state, _ = _chain_steps(chain, state, targets, x, range(10))
    save_session(str(tmp_path / "ck"), cfgs, tmap, state)
    _, ref = _chain_steps(chain, state, targets, x, range(10, 20))

    cfgs2, tmap2, rebuild, _, _, _ = load_session(str(tmp_path / "ck"))
    chain2, template, _ = build_chain(cfgs2, FS, N, channels_in=2, device="cpu")
    state2 = rebuild(template)
    assert [t.dtype for t in flatten_like_jax(state2)] == [t.dtype for t in flatten_like_jax(state)]
    assert torch.uint32 in {t.dtype for t in flatten_like_jax(state2)}
    _, got = _chain_steps(chain2, state2, chain2.targets(tmap2), x, range(10, 20))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _blocks(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, 1)).astype(np.float32) * 0.3 for _ in range(n)]


def test_engine_save_resume_session(tmp_path):
    cfg = [{"effect_id": "d", "type": "delay",
            "params": {"delay_ms": 80, "feedback": 0.5, "mix_dry": 1.0,
                       "mix_wet": 1.0, "offset_ms": 5}}]
    blocks = _blocks(9, 8)
    eng = AudioEngine(device="cpu")
    eng.build_chain(cfg)
    for b in blocks[:4]:
        eng.process_stream_block(b)
    eng.update_param("d", "feedback", 0.6)
    path = eng.save_session(str(tmp_path / "sess"))
    tail_ref = [eng.process_stream_block(b) for b in blocks[4:]]

    eng2 = AudioEngine(device="cpu")
    assert eng2.resume_session(path) == cfg
    for a, b in zip(tail_ref, [eng2.process_stream_block(b) for b in blocks[4:]]):
        assert np.array_equal(a, b)


def _wav_url(sig, fs=FS):
    wav = encode_wav_int16(np.asarray(sig, np.float32), fs)
    import base64

    return "data:audio/wav;base64," + base64.b64encode(wav).decode()


def test_engine_save_resume_with_uploaded_ir_and_profile(tmp_path):
    """A session whose convreverb carries an uploaded IR (its state leaves
    are shaped by the IR's length) and whose spectral gate carries a learned
    noise profile resumes bit-exact in a fresh engine."""
    cfg = [{"effect_id": "s", "type": "spectral",
            "params": {"threshold_db": -80.0, "reduction": 0.0, "profile_over_db": 6.0}},
           {"effect_id": "cv", "type": "convreverb",
            "params": {"ir_seconds": 0.5, "mix_dry": 0.7, "mix_wet": 0.5}}]
    rng = np.random.default_rng(17)
    ir = (rng.standard_normal((2, 13337)) *
          np.exp(-np.arange(13337) / 3000.0)).astype(np.float32) * 0.2
    blocks = _blocks(18, 6)

    eng = AudioEngine(device="cpu")
    eng.build_chain(cfg)
    eng.set_ir("cv", _wav_url(ir.T))
    eng.learn_noise("s", contents=_wav_url(noise(FS // 2, channels=1, amp=0.02)))
    for b in blocks[:3]:
        eng.process_stream_block(b)
    path = eng.save_session(str(tmp_path / "sess_ir"))
    tail_ref = [eng.process_stream_block(b) for b in blocks[3:]]

    eng2 = AudioEngine(device="cpu")  # a fresh process: no IR, no profile in memory
    assert eng2.resume_session(path) == cfg
    np.testing.assert_array_equal(eng2.noise_profiles["s"], eng.noise_profiles["s"])
    assert eng2.custom_irs["cv"][0].shape == (2, 13337)
    for a, b in zip(tail_ref, [eng2.process_stream_block(b) for b in blocks[3:]]):
        assert np.array_equal(a, b)


def test_concurrent_save_sessions_serialize(tmp_path):
    _, state, tmap = build_chain(CFGS, FS, N, channels_in=2, device="cpu")
    p = str(tmp_path / "ck")
    errs = []

    def worker():
        try:
            for _ in range(5):
                save_session(p, CFGS, tmap, state)
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errs, errs
    cfgs2, _, rebuild, _, _, meta = load_session(p)
    assert meta["gen"] == 19  # 20 saves, strictly serialized generations
    rebuild(build_chain(cfgs2, FS, N, channels_in=2, device="cpu")[1])


def test_remap_profiles_cross_rate():
    bins = 257
    prof = np.zeros(bins, np.float32)
    prof[100] = 1.0
    out = remap_profiles({"s": prof}, 44100, 48000)["s"]
    assert out.shape == prof.shape and out.dtype == np.float32
    assert int(np.argmax(out)) in (91, 92)  # bin 100 at 44100 Hz
    np.testing.assert_array_equal(out, jax_ckpt.remap_profiles({"s": prof}, 44100, 48000)["s"])
    assert np.array_equal(remap_profiles({"s": prof}, 48000, 48000)["s"], prof)
    assert np.array_equal(remap_profiles({"s": prof}, None, 48000)["s"], prof)


def test_ir_static_overrides_resample_like_jax():
    ir = noise(4000, channels=2, amp=0.2).T.copy()
    cfg = [{"effect_id": "cv", "type": "convreverb", "params": {}}]
    got = ir_static_overrides({"cv": (ir, 44100), "gone": (ir, 48000)}, cfg, FS)
    want = jax_ckpt.ir_static_overrides({"cv": (ir, 44100), "gone": (ir, 48000)}, cfg, FS)
    assert set(got) == set(want) == {"cv"}
    np.testing.assert_array_equal(got["cv"]["ir"], want["cv"]["ir"])


def test_save_session_atomic_generations(tmp_path):
    """session.json is the atomic commit point naming a generation state
    file; repeated saves prune superseded generations; an orphan file never
    confuses the loader; the flat layout (fixed state.npz) still loads."""
    _, state, tmap = build_chain(CFGS, FS, N, channels_in=2, device="cpu")
    p = str(tmp_path / "ckpt")
    save_session(p, CFGS, tmap, state)
    save_session(p, CFGS, tmap, state)
    with open(os.path.join(p, "session.json")) as f:
        meta = json.load(f)
    assert meta["gen"] == 1 and meta["state_file"] == "state-1.npz"
    assert [n for n in os.listdir(p) if n.endswith(".npz")] == ["state-1.npz"]

    with open(os.path.join(p, "state-2.npz"), "wb") as f:
        f.write(b"torn")
    cfgs2, _, rebuild, _, _, _ = load_session(p)
    _, template, _ = build_chain(cfgs2, FS, N, channels_in=2, device="cpu")
    rebuild(template)  # loads gen 1, not the torn orphan
    save_session(p, CFGS, tmap, state)
    assert sorted(n for n in os.listdir(p) if n.endswith(".npz")) == ["state-2.npz"]

    leg = str(tmp_path / "legacy")
    os.makedirs(leg)
    leaves = [t.numpy() for t in flatten_like_jax(state)]
    np.savez(os.path.join(leg, "state.npz"), **{f"leaf_{i}": v for i, v in enumerate(leaves)})
    with open(os.path.join(leg, "session.json"), "w") as f:
        json.dump({"format_version": 1, "chain_config": CFGS,
                   "targets": tmap, "n_leaves": len(leaves)}, f)
    cfgs3, _, rebuild3, _, _, _ = load_session(leg)
    assert cfgs3 == CFGS
    rebuild3(template)


def test_unsupported_format_version_raises(tmp_path):
    _, state, tmap = build_chain(CFGS, FS, N, channels_in=2, device="cpu")
    p = tmp_path / "ck"
    save_session(str(p), CFGS, tmap, state)
    meta = json.loads((p / "session.json").read_text())
    (p / "session.json").write_text(json.dumps({**meta, "format_version": 2}))
    with pytest.raises(ValueError, match="version"):
        load_session(str(p))
