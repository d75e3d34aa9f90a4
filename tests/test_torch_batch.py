"""The port's ``render_batch`` on the CPU against the JAX package's, on
tests/test_batch_render.py's three ragged files (mirrors that file).

Bars: within -90 dBFS of JAX's ``render_batch`` ("Lush Chorus" -80, the
chorus's stated exception); within 1e-5 of the port's
own per-file ``process_offline`` (the batch pads every file to the longest
file, and the effects' whole-file paths reassociate over the longer
signal); bit-equal between ``shard=True`` and ``shard=False`` on one
device, and between file orders (a fresh state per file)."""

import numpy as np
import pytest
import torch

from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.engine.engine import render_batch as jax_render_batch
from aefs_tpu_torch.engine.engine import process_offline, render_batch

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
