"""The plain block steps of kernels K1 (``octaver_step_plain``) and K3
(``chorus_step_plain``) against the JAX package's octaver and chorus,
called block by block on the same numpy inputs and params.

Octaver: blocks of 200, 256 and 4096 samples with a semitone change between
blocks (the re-anchor by fold), a JAX state just under the 2^28 horizon
carried into the port by ``core/convert.py`` (the re-anchor by count), and
the port's bitwise blocking invariance.  Chorus: streaming with a rate
change between blocks, and one whole-file call against JAX's
``process_file``.  Outputs and float state leaves <= -90 dBFS from JAX;
integer leaves exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.models.chorus import Chorus as JaxChorus
from aefs_tpu.models.octaver import Octaver as JaxOctaver
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from aefs_tpu_torch.models.chorus import Chorus
from aefs_tpu_torch.models.octaver import Octaver
from aefs_tpu_torch.ops.kernels.resample import chorus_step_plain, octaver_step_plain

from helpers import tones
from oracles import err_dbfs
from test_torch_models import assert_states_close

FS = 48000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _octaver_params(semi, mix=0.4):
    return ({"semitones": torch.tensor(semi, dtype=torch.float32),
             "mix": torch.tensor(mix, dtype=torch.float32)},
            {"semitones": jnp.float32(semi), "mix": jnp.float32(mix)})


def _blocks(x, n):
    """(frames, 2) numpy -> list of (2, n) float32 blocks."""
    return [np.ascontiguousarray(x[i:i + n].T) for i in range(0, x.shape[0], n)]


def _run_octaver_both(n, semis, x, st=None, jst=None):
    """The port's plain step and JAX's ``process`` over the same blocks;
    returns (port outputs, port state, JAX outputs, JAX state)."""
    jm = JaxOctaver(FS, n)
    st = Octaver(FS, n).init_state() if st is None else st
    jst = jm.init_state() if jst is None else jst
    jstep = jax.jit(jm.process)
    ys, jys = [], []
    for semi, blk in zip(semis, _blocks(x, n)):
        p, jp = _octaver_params(semi)
        st, y = octaver_step_plain(st, p, torch.from_numpy(blk))
        jst, jy = jstep(jst, jp, jnp.asarray(blk))
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    return ys, st, jys, jst


@pytest.mark.parametrize("n", [200, 256, 4096])
def test_octaver_step_plain_matches_jax(n):
    """Five blocks, the semitones changing after the third (-12 -> -5):
    every block's output and the final state against JAX's octaver."""
    semis = (-12.0,) * 3 + (-5.0,) * 2
    x = tones(5 * n)
    ys, st, jys, jst = _run_octaver_both(n, semis, x)
    for y, jy in zip(ys, jys):
        assert err_dbfs(y, jy) <= -90, err_dbfs(y, jy)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst))
    assert int(st["n_abs"]) == 2 * n  # re-anchored at the change


def test_octaver_step_plain_reanchors_from_jax_state():
    """A JAX stream whose n_abs sits 100 samples under 2^28 is handed to the
    port through ``core/convert.py``; both continue and re-anchor at the
    second block (n_abs >= 2^28) to the same state."""
    n = 256
    jm = JaxOctaver(FS, n)
    jst = jm.init_state()
    p, jp = _octaver_params(-12.0)
    x = tones(5 * n)
    blocks = _blocks(x, n)
    jst, _ = jax.jit(jm.process)(jst, jp, jnp.asarray(blocks[0]))
    handoff = jax.tree.map(np.asarray, jst)
    handoff["n_abs"] = np.int32((1 << 28) - 100)
    handoff["base_hi"] = np.float32(0.8125)
    st = state_from_numpy(handoff, "cpu")
    assert st["n_abs"].dtype == torch.int32
    ys, st, jys, jst = _run_octaver_both(n, (-12.0,) * 4, x[n:], st=st,
                                         jst=jax.tree.map(jnp.asarray, handoff))
    for y, jy in zip(ys, jys):
        assert err_dbfs(y, jy) <= -90, err_dbfs(y, jy)
    assert int(st["n_abs"]) == int(jst["n_abs"]) == 3 * n
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst))


def test_octaver_step_plain_blocking_invariance_bitwise():
    """At constant semitones the phase is a pure function of the absolute
    index: blocks of 200, 256, 3200 and one 6400-sample call render the same
    bits, and carry the same ring."""
    x = tones(6400)
    p, _ = _octaver_params(-7.0)
    outs, rings = [], []
    for n in (200, 256, 3200, 6400):
        st = Octaver(FS, n).init_state()
        ys = []
        for blk in _blocks(x, n):
            st, y = octaver_step_plain(st, p, torch.from_numpy(blk))
            ys.append(y)
        outs.append(torch.cat(ys, 1))
        rings.append(st["hist"])
    for y, ring in zip(outs[1:], rings[1:]):
        assert torch.equal(y, outs[0]) and torch.equal(ring, rings[0])


def _chorus_params(rate, base_ms=14.0, depth_ms=4.0, mix=0.5, spread=0.25):
    vals = {"rate_hz": rate, "depth_ms": depth_ms, "base_ms": base_ms, "mix": mix,
            "spread": spread}
    return ({k: torch.tensor(v, dtype=torch.float32) for k, v in vals.items()},
            {k: jnp.float32(v) for k, v in vals.items()})


def test_chorus_step_plain_matches_jax_streaming():
    """256-sample blocks, the LFO rate changing from 0.6 to 4 Hz after six
    blocks: every block's output and the final state against JAX's chorus."""
    n = 256
    jm = JaxChorus(FS, n)
    jstep = jax.jit(jm.process)
    st, jst = Chorus(FS, n).init_state(), jm.init_state()
    for i, blk in enumerate(_blocks(tones(12 * n), n)):
        p, jp = _chorus_params(0.6 if i < 6 else 4.0)
        st, y = chorus_step_plain(st, p, torch.from_numpy(blk), FS)
        jst, jy = jstep(jst, jp, jnp.asarray(blk))
        assert err_dbfs(y.numpy(), jy) <= -90, (i, err_dbfs(y.numpy(), jy))
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst))


@pytest.mark.parametrize("rate", [0.6, 4.0])
def test_chorus_step_plain_matches_jax_file(rate):
    """One call over a whole 6 x 4096-sample signal against JAX's
    ``process_file`` (its dense one-hot tap operator: the same taps, the
    four-term sum in another order)."""
    n = 6 * 4096
    x = np.ascontiguousarray(tones(n).T)
    p, jp = _chorus_params(rate, base_ms=20.0, depth_ms=8.0, spread=0.5)
    st, y = chorus_step_plain(Chorus(FS, 4096).init_state(), p, torch.from_numpy(x), FS)
    jm = JaxChorus(FS, 4096)
    jst, jy = jax.jit(jm.process_file)(jm.init_state(), jp, jnp.asarray(x))
    assert err_dbfs(y.numpy(), jy) <= -90, err_dbfs(y.numpy(), jy)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst))


def test_step_kernel_constants_match_dsphase():
    """The octaver kernel's float32 constants (csrc/resample.cu) are bit for
    bit the plain step's: 1/12 as (hi, lo), the 2^r Taylor pairs, and
    float32(2 pi)."""
    import math
    import re

    from aefs_tpu_torch.ops.dsphase import _EXP2_C, _INV12_HI, _INV12_LO
    from aefs_tpu_torch.ops.kernels import CSRC

    src = (CSRC / "resample.cu").read_text()

    def floats(name):
        body = re.search(name + r"(?:\[13\])?\s*=\s*\{?([^;}]*)", src).group(1)
        return [float.fromhex(t.strip().rstrip("f")) for t in body.split(",") if t.strip()]

    assert floats("kInv12Hi") == [_INV12_HI] and floats("kInv12Lo") == [_INV12_LO]
    assert floats("kExp2Hi") == [h for h, _ in _EXP2_C]
    assert floats("kExp2Lo") == [lo for _, lo in _EXP2_C]
    two_pi = np.float32(2.0 * math.pi)
    assert "(float)(2.0 * 3.14159265358979323846)" in src
    assert float(np.float32(2.0 * 3.14159265358979323846)) == float(two_pi)


@pytest.mark.parametrize("kind", ["octaver", "chorus"])
def test_steps_take_shared_params_over_slots(kind):
    """A batched file render's files reach K1 and K3 as slots with 0-dim
    params shared by all of them: the wrappers repeat each param per slot,
    so the outputs and every state leaf (shaped (S,) per slot) are those
    of the same step with the params given per slot, bit for bit."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    rng = np.random.default_rng(12)
    s, n = 3, 3000
    if kind == "octaver":
        one = Octaver(FS, n).init_state()
        p = {"semitones": torch.tensor(-5.0), "mix": torch.tensor(0.4)}
        step = octaver_step
    else:
        one = Chorus(FS, n).init_state()
        p = {k: torch.tensor(v) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
                                             ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
        step = lambda st, pp, xx: chorus_step(st, pp, xx, FS)  # noqa: E731
    state = {k: v.expand((s,) + v.shape).clone() for k, v in one.items()}
    state["hist"] = torch.from_numpy(
        (0.3 * rng.standard_normal(state["hist"].shape)).astype(np.float32))
    x = torch.from_numpy((0.3 * rng.standard_normal((s, 2, n))).astype(np.float32))
    st_shared, y_shared = step(state, p, x)
    st_slots, y_slots = step(state, {k: v.expand(s).clone() for k, v in p.items()}, x)
    assert torch.equal(y_shared, y_slots)
    for k, v in st_slots.items():
        assert st_shared[k].shape == v.shape and v.shape[0] == s, k
        assert torch.equal(st_shared[k], v), k
