"""The port's ``render_batch`` on the CPU against the JAX package's, on
tests/test_batch_render.py's three ragged files (mirrors that file), and
the batched whole-file pass under it.

Bars: within -90 dBFS of JAX's ``render_batch`` ("Lush Chorus" -80, the
chorus's stated exception); within 1e-5 of the port's
own per-file ``process_offline`` (the batch pads every file to the longest
file, and the effects' whole-file paths reassociate over the longer
signal); bit-equal between ``shard=True`` and ``shard=False`` on one
device, and between file orders (a fresh state per file).

The batched pass: every preset, the flagship and the flagship with its
octaver at -5 semitones (K1's slot grid instead of the exact grid) within
-120 dBFS of the per-file ``process_offline`` over three ragged files; six
presets that reach the long scans, the flanger's chunk loop, K2, the
convolution and the multiband container within -90 dBFS of JAX's
``render_batch``; one ``process_whole`` call per ``render_batch``.
``file_axis_vs_per_file`` (used by each module's test file) holds
``Chain.process_whole`` over F files at once to F single-file calls, bit
for bit on every output and state leaf."""

import copy

import numpy as np
import pytest
import torch

from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.engine.engine import render_batch as jax_render_batch
from aefs_tpu_torch.core.chain import Chain, build_chain
from aefs_tpu_torch.core.fileopts import file_static_overrides
from aefs_tpu_torch.engine.engine import process_offline, render_batch
from aefs_tpu_torch.engine.flagship import FLAGSHIP
from aefs_tpu_torch.models.base import tree_map

from helpers import bursts, noise, tones
from oracles import err_dbfs

FS = 48000
CHAIN = [
    {"effect_id": "g", "type": "gate",
     "params": {"threshold_db": -45, "attack_ms": 5, "release_ms": 100}},
    {"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.4}},
    {"effect_id": "f", "type": "filter",
     "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
    {"effect_id": "d", "type": "delay",
     "params": {"delay_ms": 375, "feedback": 0.2, "mix_dry": 1.0,
                "mix_wet": 0.6, "offset_ms": 10}},
    {"effect_id": "r", "type": "reverb",
     "params": {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0,
                "mix_dry": 0.8, "mix_wet": 0.4}},
]
SHAPES = [(30000, 2), (52000, 2), (41000, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _files():
    return [
        noise(30000, channels=1, seed=1),
        tones(52000, channels=2),
        bursts(41000, channels=1, seed=4),
    ]


@pytest.fixture(scope="module")
def port_outs():
    return render_batch(CHAIN, _files(), FS, device="cpu")


# "Lush Chorus" holds the chorus's stated bar (tests/test_torch_chain.py):
# on white noise the two packages' float32 sin differ by an ulp, ~-87 dBFS.
@pytest.mark.parametrize("name,bar", [("flagship-like", -90), ("Lush Chorus", -80)])
def test_batch_matches_jax_render_batch(name, bar, port_outs):
    cfg = CHAIN if name == "flagship-like" else DEFAULT_PRESETS[name]
    got = port_outs if name == "flagship-like" else render_batch(cfg, _files(), FS, device="cpu")
    want = jax_render_batch(cfg, _files(), FS)
    assert [o.shape for o in got] == [w.shape for w in want] == SHAPES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        assert err_dbfs(g, w) <= bar, (i, err_dbfs(g, w))


def test_batch_matches_per_file(port_outs):
    for i, (f, got) in enumerate(zip(_files(), port_outs)):
        _, ref = process_offline(CHAIN, f, FS, device="cpu")
        err = np.abs(got - ref).max()
        assert err < 1e-5, f"file {i}: max diff {err}"


def test_batch_shard_on_one_device_renders_the_same(port_outs):
    for a, b in zip(port_outs, render_batch(CHAIN, _files(), FS, shard=True, device="cpu")):
        np.testing.assert_array_equal(a, b)


def test_batch_fresh_state_per_file(port_outs):
    """Each file starts from its own fresh state: reversing the batch
    reverses the outputs, bit for bit."""
    rev = render_batch(CHAIN, _files()[::-1], FS, device="cpu")[::-1]
    for a, b in zip(port_outs, rev):
        np.testing.assert_array_equal(a, b)


def test_batch_outputs_are_clipped_and_trimmed():
    loud = [np.full((5000, 1), 0.9, np.float32), np.full((300,), -0.95, np.float32)]
    outs = render_batch([{"effect_id": "w", "type": "waveshaper",
                          "params": {"drive": 8.0, "shape": 1, "mix": 1.0, "out_gain": 4.0}}],
                        loud, FS, device="cpu")
    assert [o.shape for o in outs] == [(5000, 2), (300, 2)]
    assert all(np.max(np.abs(o)) <= 1.0 for o in outs)


def file_axis_vs_per_file(cfg, frames=3 * 4096, files=3, seed=0):
    """``Chain.process_whole`` of a stereo chain over ``files`` noise files
    at once (x (F, 2, N), ``batch_state``'s fx, the shared 0-dim params)
    against one call per file from ``init_state``: every output and every
    fx state leaf bit-equal per file (the lockstep leaves shared)."""
    chain, one, tmap = build_chain(cfg, FS, 4096, channels_in=2, channels_out=2,
                                   static_overrides=file_static_overrides(cfg), device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.3 * rng.standard_normal((files, 2, frames))).astype(np.float32))
    targets = chain.targets(tmap)
    state = {"fx": chain.batch_state(one, files)["fx"], "params": one["params"]}
    st_b, y_b = chain.process_whole(state, targets, x)
    assert y_b.shape == (files, 2, frames)
    for f in range(files):
        st, y = chain.process_whole(chain.init_state(), targets, x[f])
        assert torch.equal(y_b[f], y), (f, float((y_b[f] - y).abs().max()))

        def same(axis, b, s):
            b = b[f] if axis == 0 else b
            assert b.shape == s.shape and b.dtype == s.dtype and torch.equal(b, s)

        tree_map(same, chain.state_axes()["fx"], st_b["fx"], st["fx"])


def _flagship_at(semitones):
    cfg = copy.deepcopy(FLAGSHIP)
    next(c for c in cfg if c["type"] == "octaver")["params"]["semitones"] = semitones
    return cfg


CONFIGS = {**DEFAULT_PRESETS, "flagship": FLAGSHIP, "flagship -5 st": _flagship_at(-5)}


def _ragged():
    return [noise(9000, channels=1, seed=1), tones(14000, channels=2),
            bursts(11000, channels=1, seed=4)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_render_matches_per_file_render(name):
    """Every preset, the flagship and K1's fallback: the batched pass over
    three ragged files within -120 dBFS of each file's own render."""
    cfg = CONFIGS[name]
    outs = render_batch(cfg, _ragged(), FS, device="cpu")
    for i, (f, got) in enumerate(zip(_ragged(), outs)):
        _, ref = process_offline(cfg, f, FS, device="cpu")
        assert got.shape == ref.shape == (f.shape[0], 2)
        assert err_dbfs(got, ref) <= -120, (i, err_dbfs(got, ref))


@pytest.mark.parametrize("name", ["flagship", "Jet Flanger", "Rain Delay",
                                  "Concert Hall (Convolution)", "Glue Bus", "Broadcast Voice"])
def test_batched_render_matches_jax_render_batch(name):
    """The long scans (gate, compressor), the flanger's chunk loop, K2, the
    convolution and the multiband container: within -90 dBFS of JAX's
    vmapped ``render_batch`` on the same files."""
    cfg = CONFIGS[name]
    got = render_batch(cfg, _ragged(), FS, device="cpu")
    want = jax_render_batch(cfg, _ragged(), FS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert err_dbfs(g, w) <= -90, (i, err_dbfs(g, w))


def test_render_batch_is_one_process_whole_call(monkeypatch):
    """No per-file loop: one ``process_whole`` over (F, 1, Lp), with the
    fx state batched over F and the params 0-dim."""
    calls = []
    whole = Chain.process_whole

    def spy(self, state, targets, x):
        calls.append((tuple(x.shape), state))
        return whole(self, state, targets, x)

    monkeypatch.setattr(Chain, "process_whole", spy)
    outs = render_batch(CHAIN, _ragged(), FS, device="cpu")
    assert len(calls) == 1 and calls[0][0] == (3, 1, 16384)
    state = calls[0][1]
    assert all(v.dim() == 0 for p in state["params"] for v in p.values())
    assert state["fx"][0]["gain"].shape == (3,)  # the gate's
    assert [o.shape for o in outs] == [(9000, 2), (14000, 2), (11000, 2)]


@pytest.mark.parametrize("name", ["flagship", "flagship -5 st"])
def test_flagship_file_axis_is_per_file_bitwise(name):
    file_axis_vs_per_file(CONFIGS[name])
