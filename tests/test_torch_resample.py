"""The tap reads inside kernels K1 and K3's plain block steps (the
octaver's two-tap read, the chorus's one-stream read per row) against the
JAX package, at the streaming geometry: ring size 1920, resample tile 128,
window 640, on octaver-like phase ramps that include ring-wrap lanes; and
the step wrappers on CPU tensors, which count no launch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.ops.ringbuf import fractional_read_cubic as jax_cubic
from aefs_tpu.ops.ringbuf import fractional_read_resample2 as jax_resample2
from aefs_tpu_torch.ops.kernels.resample import octaver_step, octaver_taps_plain

from oracles import err_dbfs

SIZE, TILE, WINDOW = 1920, 128, 640


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, step_scale, seed):
    """hist/x noise and two phase ramps (p2 = p1 + 0.5) that cross the
    phasor wrap inside the block, as the octaver's do."""
    rng = np.random.default_rng(seed)
    hist = (0.3 * rng.standard_normal(SIZE)).astype(np.float32)
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    p0 = 0.995 if step_scale > 0 else 0.005
    p1 = np.mod(p0 + np.arange(n) * (step_scale / SIZE), 1.0).astype(np.float32)
    p2 = np.mod(p1 + np.float32(0.5), 1.0).astype(np.float32)
    ago1 = (p1 * SIZE).astype(np.float32)
    ago2 = (p2 * SIZE).astype(np.float32)
    ca = np.ceil(np.concatenate([ago1, ago2]))
    assert np.any((ca <= 1) | (ca >= SIZE - 1))  # wrap lanes are exercised
    return hist, x, ago1, ago2


CASES = [(n, s) for n in (256, 1024) for s in (-0.94, -0.5, 0.3, 0.9)]


@pytest.mark.parametrize("n,step_scale", CASES)
def test_plain_taps_match_jax_resample(n, step_scale):
    hist, x, ago1, ago2 = _inputs(n, step_scale, seed=n + int(100 * step_scale))
    t = [torch.from_numpy(a) for a in (hist, x, ago1, ago2)]
    s1, s2 = octaver_taps_plain(*t)
    j = [jnp.asarray(a) for a in (hist, x, ago1, ago2)]
    for use_pallas in ("interpret", False):
        r1, r2 = jax_resample2(*j, TILE, WINDOW, use_pallas=use_pallas)
        # The JAX side evaluates Catmull-Rom band weights (or the TPU
        # kernel's one-hot combine) at ulp(window): ~-95 dBFS against the
        # Hermite gather, the JAX package's own resample-vs-gather bar.
        assert err_dbfs(s1.numpy(), r1) <= -90, (use_pallas, err_dbfs(s1.numpy(), r1))
        assert err_dbfs(s2.numpy(), r2) <= -90, (use_pallas, err_dbfs(s2.numpy(), r2))


@pytest.mark.parametrize("n,step_scale", CASES)
def test_plain_taps_match_jax_gather(n, step_scale):
    """Same arithmetic as the JAX gather read: agreement to the ulp."""
    hist, x, ago1, ago2 = _inputs(n, step_scale, seed=7 * n + int(100 * step_scale))
    s1, s2 = octaver_taps_plain(*(torch.from_numpy(a) for a in (hist, x, ago1, ago2)))
    for got, ago in ((s1, ago1), (s2, ago2)):
        ref = jax_cubic(jnp.asarray(hist), jnp.asarray(x), jnp.asarray(ago))
        assert err_dbfs(got.numpy(), ref) <= -120, err_dbfs(got.numpy(), ref)


def test_plain_taps_on_cpu_do_not_count_launches():
    """The octaver's step on CPU tensors is its plain version and launches
    nothing."""
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import octaver_step_plain

    model = Octaver(48000, 256)
    hist, x, _, _ = _inputs(256, -0.5, seed=1)
    state = {**model.init_state(), "hist": torch.from_numpy(hist)}
    p = {"semitones": torch.tensor(-12.0), "mix": torch.tensor(0.4)}
    xs = torch.from_numpy(np.stack([x, -x]))
    before = octaver_step.launches
    st, y = octaver_step(state, p, xs)
    assert octaver_step.launches == before
    st_ref, y_ref = octaver_step_plain(state, p, xs)
    assert torch.equal(y, y_ref)
    assert all(torch.equal(st[k], st_ref[k]) for k in st_ref)


# --- Kernel K3: one stream's tap read per row (the chorus's tap) -----------

from aefs_tpu.ops.ringbuf import fractional_read_resample as jax_resample
from aefs_tpu_torch.ops.kernels.resample import chorus_step, fractional_read_plain

CHORUS_HIST = 2408  # int((40 + 10) * 48000 / 1000) + 8


def _chorus_rows(n, seed, rate_hz=0.6, base_ms=14.0, depth_ms=4.0, spread=0.25):
    """Two channels' history, block and chorus-law distances (LFO sweep,
    right channel offset by ``spread`` cycles), clipped as the chorus clips."""
    rng = np.random.default_rng(seed)
    hist = (0.3 * rng.standard_normal((2, CHORUS_HIST))).astype(np.float32)
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    ph = 0.13 + np.arange(n) * (rate_hz / 48000.0)
    ph = ph[None, :] + spread * np.arange(2)[:, None]
    ago = (base_ms + depth_ms * np.sin(2 * np.pi * ph)) * 48.0
    return hist, x, np.clip(ago, 2.0, CHORUS_HIST - 2).astype(np.float32)


def _wrap_rows(n, seed):
    """Two rows of octaver-like phase ramps on a 1920 ring that cross the
    ring boundary (wrap lanes) inside the block."""
    rows = [_inputs(n, s, seed=seed + i) for i, s in enumerate((-0.94, 0.9))]
    hist, x, ago = (np.stack([r[k] for r in rows]) for k in (0, 1, 2))
    ca = np.ceil(ago)
    assert np.any((ca <= 1) | (ca >= SIZE - 1))
    return hist, x, ago


K3_CASES = [("chorus", 256), ("chorus", 1024), ("wrap", 256), ("wrap", 1024)]


@pytest.mark.parametrize("geom,n", K3_CASES)
def test_fractional_read_matches_jax_resample(geom, n):
    """Both rows through K3's plain read against the JAX package's
    ``fractional_read_resample`` (Pallas in interpret mode and its XLA
    form), row by row: the band form's frac (qw - floor(qw)) rounds at
    ulp(window), the gather's (ceil(ago) - ago) at ulp(ago), ~-95 dBFS."""
    hist, x, ago = (_chorus_rows if geom == "chorus" else _wrap_rows)(n, seed=n)
    got = fractional_read_plain(*(torch.from_numpy(a) for a in (hist, x, ago))).numpy()
    assert got.shape == (2, n)
    for use_pallas in ("interpret", False):
        for r in range(2):
            ref = np.asarray(jax_resample(jnp.asarray(hist[r]), jnp.asarray(x[r]),
                                          jnp.asarray(ago[r]), TILE, WINDOW,
                                          use_pallas=use_pallas))
            assert err_dbfs(got[r], ref) <= -90, (use_pallas, r, err_dbfs(got[r], ref))


@pytest.mark.parametrize("geom,n", K3_CASES)
def test_fractional_read_plain_is_the_gather_per_row(geom, n):
    """The plain read is JAX's gather read on each row, to the ulp; a
    one-row call gives the two-row call's row."""
    hist, x, ago = (_chorus_rows if geom == "chorus" else _wrap_rows)(n, seed=3 * n)
    got = fractional_read_plain(*(torch.from_numpy(a) for a in (hist, x, ago))).numpy()
    for r in range(2):
        ref = np.asarray(jax_cubic(jnp.asarray(hist[r]), jnp.asarray(x[r]), jnp.asarray(ago[r])))
        assert err_dbfs(got[r], ref) <= -120, err_dbfs(got[r], ref)
        one = fractional_read_plain(*(torch.from_numpy(a[r:r + 1]) for a in (hist, x, ago)))
        assert np.array_equal(one.numpy()[0], got[r])


def test_fractional_read_on_cpu_does_not_count_launches():
    """The chorus's step on CPU tensors is its plain version and launches
    nothing."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step_plain

    hist, x, _ = _chorus_rows(256, seed=1)
    state = {"hist": torch.from_numpy(hist), "ph_hi": torch.tensor(0.13),
             "ph_lo": torch.tensor(0.0)}
    p = {"rate_hz": torch.tensor(0.6), "depth_ms": torch.tensor(4.0),
         "base_ms": torch.tensor(14.0), "mix": torch.tensor(0.5), "spread": torch.tensor(0.25)}
    before = chorus_step.launches
    st, y = chorus_step(state, p, torch.from_numpy(x), 48000)
    assert chorus_step.launches == before
    st_ref, y_ref = chorus_step_plain(state, p, torch.from_numpy(x), 48000)
    assert torch.equal(y, y_ref)
    assert all(torch.equal(st[k], st_ref[k]) for k in st_ref)
