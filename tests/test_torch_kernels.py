"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Needs a CUDA device and nvcc; skipped elsewhere.  Imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aefs_tpu_torch.ops.kernels import library

    library()  # builds csrc/*.cu on first use
    return torch.device("cuda")


def _noise(rng, shape, dev):
    return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(dev)


def _octaver_run(step, dev, n, semis, seed, **state_at_1):
    """Blocks of noise through an octaver step from a noise ring (mix 0.4);
    ``state_at_1`` overrides state leaves before the second block.  Returns
    (outputs, final state, launches of the kernel counted meanwhile)."""
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import octaver_step

    rng = np.random.default_rng(seed)
    st = Octaver(48000, n, device=dev).init_state()
    st["hist"] = _noise(rng, st["hist"].shape, dev)
    mix, ys = torch.tensor(0.4, device=dev), []
    before = octaver_step.launches
    for b, semi in enumerate(semis):
        if b == 1:
            st = {**st, **{k: torch.tensor(v, dtype=st[k].dtype, device=dev)
                           for k, v in state_at_1.items()}}
        st, y = step(st, {"semitones": torch.tensor(semi, device=dev), "mix": mix},
                     _noise(rng, (2, n), dev))
        ys.append(y)
    torch.cuda.synchronize()
    return ys, st, octaver_step.launches - before


def _assert_runs_bitwise(got, ref):
    """Every block's output and every final state leaf bit-equal (keys,
    shapes and dtypes of the state tree included)."""
    ys, st, _ = got
    ys_ref, st_ref, _ = ref
    assert st.keys() == st_ref.keys()
    for a, b in zip(ys, ys_ref):
        assert a.shape == b.shape and torch.equal(a, b), float((a - b).abs().max())
    for k in st_ref:
        assert st[k].shape == st_ref[k].shape and st[k].dtype == st_ref[k].dtype, k
        assert torch.equal(st[k], st_ref[k]), k


OCTAVER_GLIDES = {
    "steady-12": (-12.0,) * 6,
    "glide-12-to-5": (-12.0,) * 3 + (-5.0,) * 3,
    "plus7": (7.0,) * 6,
    "extremes": (24.0,) * 3 + (-24.0,) * 3,
}


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("glide", sorted(OCTAVER_GLIDES))
def test_octaver_step_kernel_matches_plain(dev, n, glide):
    """K1 against its plain step over six blocks, bit for bit, one launch
    per block; a semitone change re-anchors by folding the previous step."""
    from aefs_tpu_torch.ops.kernels.resample import octaver_step, octaver_step_plain

    semis = OCTAVER_GLIDES[glide]
    got = _octaver_run(octaver_step, dev, n, semis, seed=7)
    ref = _octaver_run(octaver_step_plain, dev, n, semis, seed=7)
    assert got[2] == len(semis) and ref[2] == 0
    _assert_runs_bitwise(got, ref)


def test_octaver_step_wrap_lanes(dev):
    """Phases within a sample of the ring boundary (the wrap lanes): a
    half-semitone step from phases just under 1 and just over 0."""
    from aefs_tpu_torch.ops.kernels.resample import octaver_step, octaver_step_plain

    for base in (0.9995, 0.0003):
        got = _octaver_run(octaver_step, dev, 256, (0.5,) * 3, 8, base_hi=base)
        ref = _octaver_run(octaver_step_plain, dev, 256, (0.5,) * 3, 8, base_hi=base)
        _assert_runs_bitwise(got, ref)


@pytest.mark.parametrize("n", [200, 256])
def test_octaver_step_reanchor_at_2_28(dev, n):
    """From n_abs = 2^28 - 100 the third block re-anchors (n_abs >= 2^28),
    bit for bit with the plain step; blocks of 200 are off the 128 grid."""
    from aefs_tpu_torch.ops.kernels.resample import octaver_step, octaver_step_plain

    at = {"n_abs": (1 << 28) - 100, "base_hi": 0.37}
    got = _octaver_run(octaver_step, dev, n, (-12.0,) * 4, 9, **at)
    ref = _octaver_run(octaver_step_plain, dev, n, (-12.0,) * 4, 9, **at)
    assert int(got[1]["n_abs"]) == 2 * n
    _assert_runs_bitwise(got, ref)


def test_octaver_step_rejects_bad_operands(dev):
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import octaver_step

    st = Octaver(48000, 256, device=dev).init_state()
    p = {"semitones": torch.tensor(-12.0, device=dev), "mix": torch.tensor(0.4, device=dev)}
    x = torch.zeros((2, 256), device=dev)
    bad = [
        ({**st, "hist": st["hist"].double()}, p, x),
        ({**st, "n_abs": st["n_abs"].float()}, p, x),
        ({**st, "base_hi": st["base_hi"].cpu()}, p, x),
        (st, {**p, "mix": torch.full((2,), 0.4, device=dev)}, x),
        (st, p, torch.zeros((3, 256), device=dev)),
        (st, p, x.double()),
        (st, p, torch.zeros(256, device=dev)),
    ]
    before = octaver_step.launches
    for args in bad:
        with pytest.raises(ValueError):
            octaver_step(*args)
    assert octaver_step.launches == before


@pytest.mark.parametrize("fs,blocksize,fast", [(16000, 4096, True), (48000, 200, False)],
                         ids=["16k-file-plus7", "48k-block200"])
def test_octaver_launches_k1_at_any_geometry(dev, fs, blocksize, fast):
    """The octaver launches K1 for every generic block, also where the
    reference's TPU tile rule reads with the plain gather (a 640-sample
    ring at 16 kHz; blocks that are no multiple of 128), and the card
    renders what the CPU port renders."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.fileopts import file_static_overrides
    from aefs_tpu_torch.ops.kernels.resample import octaver_step

    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": 7, "mix": 0.5}}]
    blocks = 3 if fast else 8
    x = (0.25 * np.random.default_rng(9).standard_normal((blocks * blocksize, 2))).astype(np.float32)
    outs, launched = {}, {}
    for d in ("cuda", "cpu"):
        statics = file_static_overrides(cfg) if fast else None
        chain, state, tmap = build_chain(cfg, fs, blocksize, channels_in=2,
                                         static_overrides=statics, device=d)
        before = octaver_step.launches
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x, fast=fast)
        launched[d] = octaver_step.launches - before
    assert launched == {"cuda": 1 if fast else blocks, "cpu": 0}
    err = float(np.max(np.abs(outs["cuda"].astype(np.float64) - outs["cpu"])))
    assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, err


@pytest.mark.parametrize("n", [900, 1500, 2900, 20000])
@pytest.mark.parametrize("h_static,h", [(0.05, 0.05), (0.2, 0.2), (None, 0.6)])
def test_comb_sums_kernel_matches_plain(dev, n, h_static, h):
    from aefs_tpu_torch.ops.kernels.comb import comb_sums, comb_sums_plain

    rng = np.random.default_rng(3)
    lags = (1425, 1780, 1972, 2097, 1411, 1766, 1958, 2083)
    side_of = (0, 0, 0, 0, 1, 1, 1, 1)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, n))).astype(np.float32)).to(dev)
    g = torch.from_numpy(np.linspace(0.5, 0.9, 8).astype(np.float32)).to(dev)
    ht = torch.tensor(h, dtype=torch.float32, device=dev)
    before = comb_sums.launches
    ysum, d_tail = comb_sums(x, g, ht, lags, 1408, side_of, 2, h_static)
    torch.cuda.synchronize()
    assert comb_sums.launches == before + 1
    y_ref, d_ref = comb_sums_plain(x, g, ht, lags, 1408, side_of, 2)
    assert ysum.shape == y_ref.shape and d_tail.shape == (3, 8, 1408)
    assert float((ysum - y_ref).abs().max()) < 1e-5
    assert float((d_tail - d_ref).abs().max()) < 1e-4


# The flagship reverb's lags (C = 1408) and a short set (C = min(lags) =
# 100: 50 threads at 2 lanes, not a multiple of a warp).
LAGS8 = (1425, 1780, 1972, 2097, 1411, 1766, 1958, 2083)
SHORT8 = (100, 117, 133, 151, 163, 178, 190, 199)
REVERB_SIDES = (0, 0, 0, 0, 1, 1, 1, 1)


def _comb_operands(dev, lags, rows, n, h, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.3 * rng.standard_normal((rows, n))).astype(np.float32)).to(dev)
    g = torch.from_numpy(np.linspace(0.5, 0.9, len(lags)).astype(np.float32)).to(dev)
    return x, g, torch.tensor(h, dtype=torch.float32, device=dev)


def _sums_vs_plain(dev, lags, side_of, n_sides, n, h, h_static):
    from aefs_tpu_torch.ops.kernels.comb import comb_sums, comb_sums_plain
    from aefs_tpu_torch.ops.ringbuf import comb_chunk_size

    c = comb_chunk_size(lags)
    x, g, ht = _comb_operands(dev, lags, max(side_of) + 1, n, h)
    before = comb_sums.launches
    ysum, d_tail = comb_sums(x, g, ht, lags, c, side_of, n_sides, h_static)
    torch.cuda.synchronize()
    assert comb_sums.launches == before + 1
    y_ref, d_ref = comb_sums_plain(x, g, ht, lags, c, side_of, n_sides)
    assert ysum.shape == y_ref.shape == (n_sides, -(-n // c), c)
    assert d_tail.shape == d_ref.shape == (3, len(lags), c)
    assert float((ysum - y_ref).abs().max()) < 1e-5
    assert float((d_tail - d_ref).abs().max()) < 1e-4
    return ysum


def _chunks_vs_plain(dev, lags, side_of, n, h):
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_chunks_plain
    from aefs_tpu_torch.ops.ringbuf import comb_chunk_size

    c = comb_chunk_size(lags)
    x, g, ht = _comb_operands(dev, lags, max(side_of) + 1, n, h)
    before = comb_chunks.launches
    y, d = comb_chunks(x, g, ht, lags, c, side_of)
    torch.cuda.synchronize()
    assert comb_chunks.launches == before + 1
    y_ref, d_ref = comb_chunks_plain(x, g, ht, lags, c, side_of)
    assert y.shape == d.shape == y_ref.shape == (-(-n // c), len(lags), c)
    assert float((y - y_ref).abs().max()) < 1e-5
    assert float((d - d_ref).abs().max()) < 1e-4


@pytest.mark.parametrize("n", [900, 2000, 2817, 4300], ids=["M1", "M2", "M3", "M4"])
@pytest.mark.parametrize("h,h_static", [(0.05, 0.05), (0.6, None)], ids=["fir", "scan"])
def test_comb_sums_few_chunks(dev, n, h, h_static):
    """K2 at 1-4 chunks of 1408: the tail's leading zero rows and the first
    steps, where every lag read lands before the signal start."""
    _sums_vs_plain(dev, LAGS8, REVERB_SIDES, 2, n, h, h_static)


@pytest.mark.parametrize("case", [
    ("uneven-3-5", LAGS8, (0, 0, 0, 1, 1, 1, 1, 1), 2, 20000, 0.05, 0.05),
    ("h0-one-tap", LAGS8, REVERB_SIDES, 2, 20000, 0.0, 0.0),
    ("fir-last-0.40", LAGS8, REVERB_SIDES, 2, 20000, 0.40, 0.40),
    ("scan-0.41", LAGS8, REVERB_SIDES, 2, 20000, 0.41, 0.41),
    ("short-lags-fir", SHORT8, REVERB_SIDES, 2, 3000, 0.05, 0.05),
    ("short-lags-scan", SHORT8, REVERB_SIDES, 2, 3000, 0.6, None),
], ids=lambda case: case[0])
def test_comb_sums_geometry(dev, case):
    """K2 at an uneven side map, h = 0 (a one-tap FIR), the last FIR case
    and the first scan case, and a chunk below 128 that no warp count
    divides."""
    _, lags, side_of, n_sides, n, h, h_static = case
    _sums_vs_plain(dev, lags, side_of, n_sides, n, h, h_static)


def test_comb_sums_side_without_combs(dev):
    """n_sides = 3 with combs on sides 0 and 1 only: row 2 is zeros."""
    ysum = _sums_vs_plain(dev, LAGS8, REVERB_SIDES, 3, 20000, 0.2, 0.2)
    assert not bool(ysum[2].any())


@pytest.mark.parametrize("case", [
    ("M1", LAGS8, REVERB_SIDES, 900, 0.3),
    ("M2", LAGS8, REVERB_SIDES, 2000, 0.3),
    ("M3", LAGS8, REVERB_SIDES, 2817, 0.3),
    ("M4", LAGS8, REVERB_SIDES, 4300, 0.3),
    ("uneven-3-5", LAGS8, (0, 0, 0, 1, 1, 1, 1, 1), 20000, 0.3),
    ("identity-16", LAGS8 + tuple(l + 7 for l in LAGS8), tuple(range(16)), 20000, 0.3),
    ("h0", LAGS8, REVERB_SIDES, 20000, 0.0),
    ("short-lags", SHORT8, tuple(range(8)), 3000, 0.6),
], ids=lambda case: case[0])
def test_comb_chunks_geometry(dev, case):
    """K4 at 1-4 chunks, an uneven side map, 16 combs on the identity map,
    h = 0 and a chunk of 100."""
    _, lags, side_of, n, h = case
    _chunks_vs_plain(dev, lags, side_of, n, h)


@pytest.mark.parametrize("c", [1408, 1664, 2176, 5632, 14080],
                         ids=["2-lanes", "4-lanes", "8-lanes", "16-lanes", "32-lanes"])
def test_comb_kernels_every_lanes_variant(dev, c):
    """Each lanes-per-thread variant the launcher picks, at a chunk size
    that selects it (2 lanes up to 768 threads, then the fewest of 4-32
    within 512; 32 lanes at 448 threads near the shared-memory limit):
    K2 with both dampings and K4, over 4 chunks."""
    lags = tuple(c + 17 + k * c // 10 for k in range(8))  # comb_chunk_size -> c
    n = 3 * c + 500
    _sums_vs_plain(dev, lags, REVERB_SIDES, 2, n, 0.05, 0.05)
    _sums_vs_plain(dev, lags, REVERB_SIDES, 2, n, 0.6, None)
    _chunks_vs_plain(dev, lags, REVERB_SIDES, n, 0.3)


def test_comb_kernels_are_deterministic(dev):
    """Two launches on the same inputs are bit-equal (no atomics; every
    power of h from a fixed multiplication order)."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_sums

    x, g, ht = _comb_operands(dev, LAGS8, 2, 50000, 0.6)
    for h, h_static in ((0.05, 0.05), (0.6, None)):
        hs = torch.tensor(h, device=dev)
        a = comb_sums(x, g, hs, LAGS8, 1408, REVERB_SIDES, 2, h_static)
        b = comb_sums(x, g, hs, LAGS8, 1408, REVERB_SIDES, 2, h_static)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    a = comb_chunks(x, g, ht, LAGS8, 1408, REVERB_SIDES)
    b = comb_chunks(x, g, ht, LAGS8, 1408, REVERB_SIDES)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_comb_kernels_reject_bad_geometry(dev):
    """More than 16 combs and a side map outside the rows of x raise
    before launching; a chunk whose block exceeds shared memory and one
    that no lanes variant takes return the launch error, which leaves no
    error behind for the next launch."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_sums

    x, g, ht = _comb_operands(dev, LAGS8, 2, 5000, 0.3)
    lags17 = LAGS8 * 2 + (1500,)
    g17 = torch.full((17,), 0.5, device=dev)
    with pytest.raises(ValueError):
        comb_chunks(torch.zeros((17, 5000), device=dev), g17, ht, lags17, 1408, tuple(range(17)))
    with pytest.raises(ValueError):
        comb_sums(x, g, ht, LAGS8, 1408, (0, 0, 0, 0, 2, 2, 2, 2), 3)
    for big in (15000, 17000):
        with pytest.raises(RuntimeError, match="CUDA error"):
            comb_chunks(torch.zeros((2, 40000), device=dev), g[:2], ht, (big, big + 1), big,
                        (0, 1))
    _chunks_vs_plain(dev, LAGS8, REVERB_SIDES, 5000, 0.3)


def _chorus_run(step, dev, n, rates, seed, base_ms=14.0, depth_ms=4.0):
    """Blocks of noise through a chorus step at the chorus's geometry
    (history 2408, two channels, spread 0.25, mix 0.5), one rate per block.
    Returns (outputs, final state, kernel launches counted meanwhile)."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step

    rng = np.random.default_rng(seed)
    st = {"hist": _noise(rng, (2, 2408), dev), "ph_hi": torch.tensor(0.13, device=dev),
          "ph_lo": torch.tensor(0.0, device=dev)}
    fixed = {k: torch.tensor(v, device=dev) for k, v in
             (("depth_ms", depth_ms), ("base_ms", base_ms), ("mix", 0.5), ("spread", 0.25))}
    ys, before = [], chorus_step.launches
    for rate in rates:
        st, y = step(st, {**fixed, "rate_hz": torch.tensor(rate, device=dev)},
                     _noise(rng, (2, n), dev), 48000)
        ys.append(y)
    torch.cuda.synchronize()
    return ys, st, chorus_step.launches - before


@pytest.mark.parametrize("n,rates", [(256, (0.6,) * 3 + (4.0,) * 3), (892800, (0.6,))],
                         ids=["2x256-rate-change", "2x892800"])
def test_fractional_read_kernel_matches_plain_bitwise(dev, n, rates):
    """K3 against its plain step, bit for bit, one launch per block: at the
    chorus's streaming block with a rate change, and at the demo file's
    length (2 x 892,800 outputs) in one call."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, chorus_step_plain

    got = _chorus_run(chorus_step, dev, n, rates, seed=n)
    ref = _chorus_run(chorus_step_plain, dev, n, rates, seed=n)
    assert got[2] == len(rates) and ref[2] == 0
    _assert_runs_bitwise(got, ref)


def test_fractional_read_kernel_wrap_lanes_bitwise(dev):
    """The chorus's delay law where the clamp cuts it (base 1 ms, depth
    10 ms: distances held at 2 samples, the nearest the reads come to the
    ring boundary), bit for bit."""
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, chorus_step_plain

    got = _chorus_run(chorus_step, dev, 256, (2.0,) * 6, 10, base_ms=1.0, depth_ms=10.0)
    ref = _chorus_run(chorus_step_plain, dev, 256, (2.0,) * 6, 10, base_ms=1.0, depth_ms=10.0)
    _assert_runs_bitwise(got, ref)


def test_fractional_read_rejects_bad_operands(dev):
    from aefs_tpu_torch.ops.kernels.resample import chorus_step

    st = {"hist": torch.zeros((2, 2408), device=dev), "ph_hi": torch.tensor(0.1, device=dev),
          "ph_lo": torch.tensor(0.0, device=dev)}
    p = {k: torch.tensor(v, device=dev) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
         ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
    x = torch.zeros((2, 256), device=dev)
    bad = [
        ({**st, "hist": st["hist"][:1]}, p, x),
        ({**st, "hist": st["hist"].T.contiguous().T}, p, x),  # not contiguous
        ({**st, "hist": st["hist"].double()}, p, x),
        ({**st, "ph_lo": st["ph_lo"].double()}, p, x),
        (st, {**p, "rate_hz": p["rate_hz"].cpu()}, x),
        (st, p, x.double()),
    ]
    before = chorus_step.launches
    for args in bad:
        with pytest.raises(ValueError):
            chorus_step(*args, 48000)
    assert chorus_step.launches == before


def test_chorus_streaming_step_launches_k3_once_per_block(dev):
    """The chorus runs its block step K3 on the card: one launch per block
    (both channels), never the plain step, and renders what the CPU renders."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.ops.kernels.resample import chorus_step

    cfg = DEFAULT_PRESETS["Lush Chorus"]
    x = (0.25 * np.random.default_rng(11).standard_normal((12 * 256, 1))).astype(np.float32)
    outs, launched = {}, {}
    for d in ("cuda", "cpu"):
        chain, state, tmap = build_chain(cfg, 48000, 256, channels_in=1, device=d)
        before = chorus_step.launches
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x)
        launched[d] = chorus_step.launches - before
    assert launched == {"cuda": 12, "cpu": 0}
    err = float(np.max(np.abs(outs["cuda"].astype(np.float64) - outs["cpu"])))
    assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, err


def test_step_kernels_take_strided_blocks(dev):
    """A block sliced out of a longer (C, T) signal (rows T apart, as the
    chain's blocks are) gives what its contiguous copy gives."""
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    rng = np.random.default_rng(13)
    long = _noise(rng, (2, 4 * 256), dev)
    xs = long[:, 256:512]
    assert not xs.is_contiguous()
    st = Octaver(48000, 256, device=dev).init_state()
    p = {"semitones": torch.tensor(-12.0, device=dev), "mix": torch.tensor(0.4, device=dev)}
    assert torch.equal(octaver_step(st, p, xs)[1], octaver_step(st, p, xs.contiguous())[1])
    cst = {"hist": _noise(rng, (2, 2408), dev), "ph_hi": torch.tensor(0.1, device=dev),
           "ph_lo": torch.tensor(0.0, device=dev)}
    cp = {k: torch.tensor(v, device=dev) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
          ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
    assert torch.equal(chorus_step(cst, cp, xs, 48000)[1],
                       chorus_step(cst, cp, xs.contiguous(), 48000)[1])


@pytest.mark.parametrize("n", [900, 20000, 892800])
@pytest.mark.parametrize("sides", ["identity", "reverb"])
def test_comb_chunks_kernel_matches_plain(dev, n, sides):
    """K4 against its plain version at K2's tolerances (1e-5 on y, 1e-4 on
    damped), through its entry ``ringbuf.comb_bank_file_chunks``."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_chunks_plain
    from aefs_tpu_torch.ops.ringbuf import comb_bank_file_chunks

    lags = (1425, 1780, 1972, 2097, 1411, 1766, 1958, 2083)
    side_of = tuple(range(8)) if sides == "identity" else (0, 0, 0, 0, 1, 1, 1, 1)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.3 * rng.standard_normal((max(side_of) + 1, n)))
                         .astype(np.float32)).to(dev)
    g = torch.from_numpy(np.linspace(0.5, 0.9, 8).astype(np.float32)).to(dev)
    h = torch.tensor(0.3, device=dev)
    before = comb_chunks.launches
    y, d, c = comb_bank_file_chunks(x, lags, g, h, side_of=side_of)
    torch.cuda.synchronize()
    assert comb_chunks.launches == before + 1 and c == 1408
    y_ref, d_ref = comb_chunks_plain(x, g, h, lags, c, side_of)
    assert y.shape == y_ref.shape == (-(-n // c), 8, c)
    assert float((y - y_ref).abs().max()) < 1e-5
    assert float((d - d_ref).abs().max()) < 1e-4


def test_u32_accumulator_on_the_card(dev):
    """The ring mod's uint32 accumulator advances on the card exactly as on
    the CPU, across a wrap."""
    from aefs_tpu_torch.models.ringmod import advance_u32, phase_ramp_cycles, phase_step_u32

    outs = {}
    for d in ("cuda", "cpu"):
        acc = torch.tensor(2**32 - 12345, dtype=torch.uint32).to(d)
        num = phase_step_u32(torch.tensor(4321.0, device=d), 48000)
        outs[d] = (advance_u32(acc, num, 256).cpu(), phase_ramp_cycles(acc, num, 4096).cpu())
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    assert torch.equal(outs["cuda"][1], outs["cpu"][1])


def _noise_plus_tones(frames, seed=12):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 48000.0
    tone = sum(np.sin(2 * np.pi * f * t + i) for i, f in enumerate((220.0, 1340.0, 6100.0))) / 3
    return (0.1 * rng.standard_normal((frames, 2)) + 0.2 * tone[:, None]).astype(np.float32)


@pytest.mark.parametrize("etype,params", [
    ("spectral", {"threshold_db": -50.0, "reduction": 0.1}),
    ("compressor", {"threshold_db": -18.0, "ratio": 3.0, "attack_ms": 30.0,
                    "release_ms": 200.0, "knee_db": 6.0, "makeup_db": 3.0}),
], ids=["spectral", "compressor"])
@pytest.mark.parametrize("blocksize,fast", [(256, False), (4096, True)], ids=["stream", "file"])
def test_last_slice_card_matches_cpu(dev, etype, params, blocksize, fast):
    """The spectral gate ("Clean Noise Removal") and the compressor ("Glue
    Bus") on the card against the CPU, on 2 s of noise plus tones, 256-sample
    streaming and file mode, within -90 dBFS.  The gate's mask is a hard
    decision on cuFFT's magnitudes against pocketfft's; the compressor's
    coefficients are float64-rounded, its per-sample log10/pow float32.
    Measured on an H100 80GB HBM3 at 700 W: the gate -136.5 (streaming) and
    -137.5 dBFS (file), no mask decision flipped of 96,375; the compressor
    -144.5 dBFS in both modes."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.fileopts import file_static_overrides

    cfg = [{"effect_id": "e", "type": etype, "params": params}]
    x = _noise_plus_tones(96000)
    outs = {}
    for d in ("cuda", "cpu"):
        chain, state, tmap = build_chain(
            cfg, 48000, blocksize, channels_in=2, device=d,
            static_overrides=file_static_overrides(cfg) if fast else None)
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x, fast=fast)
    assert np.all(np.isfinite(outs["cuda"]))
    err = float(np.max(np.abs(outs["cuda"].astype(np.float64) - outs["cpu"])))
    assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, err


def test_multiband_master_card_matches_cpu(dev):
    """The float64 biquads at the 150 Hz crossover, three compressors, width
    and the limiter: 256-sample streaming on the card against the CPU
    (measured -147.0 dBFS on an H100 80GB HBM3 at 700 W)."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    x = _noise_plus_tones(40 * 256)[:, :1]
    outs = {}
    for d in ("cuda", "cpu"):
        chain, state, tmap = build_chain(DEFAULT_PRESETS["Multiband Master"], 48000, 256,
                                         channels_in=1, device=d)
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x)
    err = float(np.max(np.abs(outs["cuda"].astype(np.float64) - outs["cpu"])))
    assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, err


# --- The slot grids (the serving pool): one launch steps S slots ----------

def _slot_run(step, dev, kind, slots, blocks, seed, n=256):
    """``blocks`` blocks of noise through a step with a leading slot axis,
    each slot with its own params: the octaver's semitones spread over
    [-24, 24] with slot 0 gliding (a re-anchor mid-run) and one slot from
    n_abs near 2^28, different mixes; the chorus's rates spread over
    [0.1, 9.5] with slot 0 changing mid-run and one slot whose delay law the
    clamp cuts.  ``step`` takes the whole batch (``_per_slot`` wraps a
    step that runs slot by slot).  Returns (outputs per block, final state,
    kernel launches meanwhile)."""
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    rng = np.random.default_rng(seed)
    lin = torch.linspace(0.0, 1.0, slots, device=dev)
    if kind == "octaver":
        one = Octaver(48000, n, device=dev).init_state()
        st = {k: v.expand((slots,) + v.shape).clone() for k, v in one.items()}
        st["hist"] = _noise(rng, st["hist"].shape, dev)
        st["n_abs"][-1] = (1 << 28) - 300
        mix = 0.1 + 0.8 * lin
        kernel = octaver_step
    else:
        st = {"hist": _noise(rng, (slots, 2, 2408), dev),
              "ph_hi": 0.9 * lin, "ph_lo": torch.zeros(slots, device=dev)}
        fixed = {"depth_ms": 2.0 + 8.0 * lin, "base_ms": 14.0 + 20.0 * lin,
                 "mix": 0.2 + 0.8 * lin, "spread": 0.5 * lin}
        fixed["depth_ms"][-1], fixed["base_ms"][-1] = 10.0, 1.0  # the clamp cuts it
        kernel = chorus_step
    ys, before = [], kernel.launches
    for b in range(blocks):
        x = _noise(rng, (slots, 2, n), dev)
        if kind == "octaver":
            semis = -24.0 + 48.0 * lin
            semis[0] = -12.0 if b < blocks // 2 else -5.0
            p = {"semitones": semis, "mix": mix}
        else:
            rates = 0.1 + 9.4 * lin
            rates[0] = 0.6 if b < blocks // 2 else 4.0
            p = {**fixed, "rate_hz": rates}
        st, y = step(st, p, x)
        ys.append(y)
    torch.cuda.synchronize()
    return ys, st, kernel.launches - before


def _per_slot(step, fs=None):
    """``step`` applied slot by slot without slot dims (S = 1 launches on
    the card), results stacked back along the slot axis."""
    def run(st, p, x):
        outs = []
        for s in range(x.shape[0]):
            args = ({k: v[s] for k, v in st.items()}, {k: v[s] for k, v in p.items()}, x[s])
            outs.append(step(*args) if fs is None else step(*args, fs))
        return ({k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]},
                torch.stack([o[1] for o in outs]))
    return run


@pytest.mark.parametrize("slots", [1, 3, 16])
@pytest.mark.parametrize("kind", ["octaver", "chorus"])
def test_step_kernel_slot_grid_bitwise(dev, kind, slots):
    """K1 and K3 with a slot grid: one launch per block for all slots, each
    slot bit-equal to the plain step on that slot and to an S = 1 launch on
    that slot's inputs, over 8 blocks (state leaves included)."""
    from aefs_tpu_torch.ops.kernels.resample import (
        chorus_step, chorus_step_plain, octaver_step, octaver_step_plain)

    if kind == "octaver":
        kern, plain, fs = octaver_step, octaver_step_plain, None
    else:
        kern = lambda st, p, x: chorus_step(st, p, x, 48000)  # noqa: E731
        plain = lambda st, p, x: chorus_step_plain(st, p, x, 48000)  # noqa: E731
        fs = 48000
    got = _slot_run(kern, dev, kind, slots, 8, seed=40 + slots)
    assert got[2] == 8
    _assert_runs_bitwise(got, _slot_run(plain, dev, kind, slots, 8, seed=40 + slots))
    single = _per_slot(octaver_step if kind == "octaver" else chorus_step, fs)
    ref = _slot_run(single, dev, kind, slots, 8, seed=40 + slots)
    assert ref[2] == 8 * slots
    _assert_runs_bitwise(got, ref)


def test_step_kernels_reject_bad_slot_operands(dev):
    """A param or state scalar whose slot dims differ from x's is refused
    before any launch (a 0-dim param is shared by every slot)."""
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step

    one = Octaver(48000, 256, device=dev).init_state()
    st = {k: v.expand((4,) + v.shape).clone() for k, v in one.items()}
    p = {"semitones": torch.full((4,), -12.0, device=dev), "mix": torch.full((4,), 0.4, device=dev)}
    x = torch.zeros((4, 2, 256), device=dev)
    cst = {"hist": torch.zeros((4, 2, 2408), device=dev), "ph_hi": torch.zeros(4, device=dev),
           "ph_lo": torch.zeros(4, device=dev)}
    cp = {k: torch.full((4,), v, device=dev) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
          ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
    bad_oct = [
        ({**st, "hist": st["hist"][:3]}, p, x),
        ({**st, "n_abs": st["n_abs"][0]}, p, x),
        (st, {**p, "mix": torch.full((3,), 0.4, device=dev)}, x),
        (st, {**p, "semitones": torch.full((8,), -12.0, device=dev)[::2]}, x),  # strided
    ]
    bad_cho = [
        ({**cst, "hist": cst["hist"][:, :1]}, cp, x),
        ({**cst, "ph_hi": cst["ph_hi"][:2]}, cp, x),
        (cst, {**cp, "rate_hz": torch.full((5,), 0.6, device=dev)}, x),
    ]
    before = (octaver_step.launches, chorus_step.launches)
    for args in bad_oct:
        with pytest.raises(ValueError):
            octaver_step(*args)
    for args in bad_cho:
        with pytest.raises(ValueError):
            chorus_step(*args, 48000)
    assert (octaver_step.launches, chorus_step.launches) == before


def test_pool_step_launches_each_step_kernel_once(dev):
    """A flagship pool and a "Lush Chorus" pool of 16 slots on the card:
    K1 (resp. K3) launches once per pool step, and each slot renders what
    the CPU pool renders."""
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.engine.flagship import FLAGSHIP
    from aefs_tpu_torch.ops.kernels.resample import chorus_step, octaver_step
    from aefs_tpu_torch.server.pool import SessionPool

    x = (0.25 * np.random.default_rng(12).standard_normal((6, 16, 256))).astype(np.float32)
    for cfg, kernel in ((FLAGSHIP, octaver_step), (DEFAULT_PRESETS["Lush Chorus"], chorus_step)):
        outs = {}
        for d in ("cuda", "cpu"):
            pool = SessionPool(cfg, n_slots=16, device=d)
            before = kernel.launches
            outs[d] = [pool.step_blocks({s: x[b, s] for s in range(16)}) for b in range(6)]
            assert kernel.launches - before == (6 if d == "cuda" else 0)
        for b in range(6):
            for s in range(16):
                err = float(np.max(np.abs(outs["cuda"][b][s].astype(np.float64)
                                          - outs["cpu"][b][s])))
                assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, (b, s, err)


def _file_axis_comb_operands(dev, files, n, h, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.3 * rng.standard_normal((files, 2, n))).astype(np.float32)).to(dev)
    g = torch.from_numpy(np.linspace(0.5, 0.9, 8).astype(np.float32)).to(dev)
    return x, g, torch.tensor(h, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("files", [1, 3, 16])
@pytest.mark.parametrize("h,h_static", [(0.05, 0.05), (0.6, None)], ids=["fir", "scan"])
def test_comb_sums_file_grid(dev, files, h, h_static):
    """K2 with a file axis, x (F, 2, N): one launch for all F files, each
    file bit-equal to an F = 1 launch on its rows, and within K2's bars of
    the plain version on that file (whose damping is the exact propagator,
    not the kernel's FIR or scan); the plain version over F bit-equal to
    its per-file calls."""
    from aefs_tpu_torch.ops.kernels.comb import comb_sums, comb_sums_plain

    x, g, ht = _file_axis_comb_operands(dev, files, 20000, h, seed=files)
    before = comb_sums.launches
    ysum, d_tail = comb_sums(x, g, ht, LAGS8, 1408, REVERB_SIDES, 2, h_static)
    torch.cuda.synchronize()
    assert comb_sums.launches == before + 1
    assert ysum.shape == (files, 2, 15, 1408) and d_tail.shape == (files, 3, 8, 1408)
    y_plain, d_plain = comb_sums_plain(x, g, ht, LAGS8, 1408, REVERB_SIDES, 2)
    for f in range(files):
        y1, d1 = comb_sums(x[f], g, ht, LAGS8, 1408, REVERB_SIDES, 2, h_static)
        assert torch.equal(ysum[f], y1) and torch.equal(d_tail[f], d1), f
        yp, dp = comb_sums_plain(x[f], g, ht, LAGS8, 1408, REVERB_SIDES, 2)
        assert torch.equal(y_plain[f], yp) and torch.equal(d_plain[f], dp), f
        assert float((ysum[f] - yp).abs().max()) < 1e-5
        assert float((d_tail[f] - dp).abs().max()) < 1e-4


@pytest.mark.parametrize("files", [1, 3, 16])
def test_comb_chunks_file_grid(dev, files):
    """K4 shares K2's launcher and its file grid: each file of one launch
    bit-equal to an F = 1 launch, within the bars of the plain version."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_chunks_plain

    x, g, ht = _file_axis_comb_operands(dev, files, 4300, 0.3, seed=20 + files)
    before = comb_chunks.launches
    y, d = comb_chunks(x, g, ht, LAGS8, 1408, REVERB_SIDES)
    torch.cuda.synchronize()
    assert comb_chunks.launches == before + 1 and y.shape == d.shape == (files, 4, 8, 1408)
    for f in range(files):
        y1, d1 = comb_chunks(x[f], g, ht, LAGS8, 1408, REVERB_SIDES)
        assert torch.equal(y[f], y1) and torch.equal(d[f], d1), f
        yp, dp = comb_chunks_plain(x[f], g, ht, LAGS8, 1408, REVERB_SIDES)
        assert float((y[f] - yp).abs().max()) < 1e-5
        assert float((d[f] - dp).abs().max()) < 1e-4


def test_comb_kernels_reject_bad_file_operands(dev):
    """No file, a fourth axis, more files than the grid takes and a strided
    file axis raise before any launch."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_sums

    _, g, ht = _file_axis_comb_operands(dev, 1, 10, 0.3, seed=0)
    bad = [torch.zeros((0, 2, 5000), device=dev), torch.zeros((2, 2, 2, 5000), device=dev),
           torch.zeros((65536, 2, 1), device=dev), torch.zeros((6, 2, 5000), device=dev)[::2]]
    before = (comb_sums.launches, comb_chunks.launches)
    for x in bad:
        with pytest.raises(ValueError):
            comb_sums(x, g, ht, LAGS8, 1408, REVERB_SIDES, 2, 0.05)
        with pytest.raises(ValueError):
            comb_chunks(x, g, ht, LAGS8, 1408, REVERB_SIDES)
    assert (comb_sums.launches, comb_chunks.launches) == before


@pytest.mark.parametrize("kind", ["octaver", "chorus"])
def test_step_kernels_file_length_slots_bitwise(dev, kind):
    """K1 and K3 as a batched render runs them: three files as slots at the
    demo's length (892,800), from fresh state, params 0-dim and shared: one
    launch, each slot bit-equal to the plain step and to an S = 1 launch."""
    from aefs_tpu_torch.models.chorus import Chorus
    from aefs_tpu_torch.models.octaver import Octaver
    from aefs_tpu_torch.ops.kernels.resample import (
        chorus_step, chorus_step_plain, octaver_step, octaver_step_plain)

    rng = np.random.default_rng(30)
    n, s = 892800, 3
    if kind == "octaver":
        one = Octaver(48000, 4096, device=dev).init_state()
        p = {"semitones": torch.tensor(-5.0, device=dev), "mix": torch.tensor(0.4, device=dev)}
        kern, plain = octaver_step, octaver_step_plain
    else:
        one = Chorus(48000, 4096, device=dev).init_state()
        p = {k: torch.tensor(v, device=dev) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
             ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
        kern = lambda st, pp, xx: chorus_step(st, pp, xx, 48000)  # noqa: E731
        plain = lambda st, pp, xx: chorus_step_plain(st, pp, xx, 48000)  # noqa: E731
    st = {k: v.expand((s,) + v.shape).clone() for k, v in one.items()}
    x = _noise(rng, (s, 2, n), dev)
    counter = octaver_step if kind == "octaver" else chorus_step
    before = counter.launches
    got = kern(st, p, x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = plain(st, {k: v.expand(s).contiguous() for k, v in p.items()}, x)
    assert torch.equal(got[1], ref[1])
    for k in ref[0]:
        assert got[0][k].shape == ref[0][k].shape and torch.equal(got[0][k], ref[0][k]), k
    for f in range(s):
        one_st, one_y = kern({k: v[f] for k, v in st.items()}, p, x[f])
        assert torch.equal(got[1][f], one_y)
        assert all(torch.equal(got[0][k][f], one_st[k]) for k in one_st)


# --- K5: the biquad's streaming block step ---------------------------------

BIQUAD_CUTOFFS = (20.0, 150.0, 1000.0, 4000.0, 20000.0)
BIQUAD_QS = (0.1, 0.707, 10.0)
BIQUAD_GAINS = (-24.0, 0.0, 24.0)


def _biquad_grid(dev, ftype):
    """One slot per (cutoff, q, gain) of the grid above, all of ``ftype``."""
    grid = np.array([(f, q, g) for f in BIQUAD_CUTOFFS for q in BIQUAD_QS
                     for g in BIQUAD_GAINS], np.float32)
    cols = {"cutoff_hz": grid[:, 0], "q": grid[:, 1], "gain_db": grid[:, 2],
            "filter_type": np.full(len(grid), ftype, np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


def _biquad_run(step, dev, n, params, seed, fs=48000):
    """Blocks of noise (two channels) through a biquad step from a noise
    state, one params dict per block (a slot axis when the params have
    one).  Returns (outputs, final state, kernel launches meanwhile)."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step

    rng = np.random.default_rng(seed)
    lead = tuple(params[0]["cutoff_hz"].shape)
    st = {"df1": _noise(rng, lead + (2, 4), dev)}
    ys, before = [], biquad_step.launches
    for p in params:
        st, y = step(st, p, _noise(rng, lead + (2, n), dev), fs)
        ys.append(y)
    torch.cuda.synchronize()
    return ys, st, biquad_step.launches - before


@pytest.mark.parametrize("n", [64, 256, 512, 1023])
@pytest.mark.parametrize("fs", [48000, 16000])
@pytest.mark.parametrize("ftype", range(7))
def test_biquad_step_kernel_matches_plain(dev, ftype, fs, n):
    """K5 against its plain step on the card, bit for bit (outputs and
    state), over two blocks: every filter type, at cutoffs 20 Hz to 20 kHz
    (20 kHz meets the 0.45 fs clamp at both rates), q 0.1 to 10 and gains
    -24 to +24 dB, one slot each: 45 slots in one launch.  From 512
    samples the planes need more than the default 48 KB of shared memory."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step, biquad_step_plain

    params = [_biquad_grid(dev, ftype)] * 2
    got = _biquad_run(biquad_step, dev, n, params, seed=ftype, fs=fs)
    ref = _biquad_run(biquad_step_plain, dev, n, params, seed=ftype, fs=fs)
    assert got[2] == 2 and ref[2] == 0
    _assert_runs_bitwise(got, ref)


@pytest.mark.parametrize("slots", [1, 16, 64])
def test_biquad_step_slot_grid_bitwise(dev, slots):
    """K5 with a slot grid over 8 blocks, each slot with its own type,
    cutoff, q and gain: one launch a block for all slots, bit-equal to the
    plain step and to S = 1 launches on each slot's inputs."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step, biquad_step_plain

    rng = np.random.default_rng(slots)
    p = {"filter_type": np.arange(slots) % 7,
         "cutoff_hz": np.exp(rng.uniform(np.log(20.0), np.log(20000.0), slots)),
         "q": rng.uniform(0.1, 10.0, slots), "gain_db": rng.uniform(-24.0, 24.0, slots)}
    params = [{k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in p.items()}] * 8
    got = _biquad_run(biquad_step, dev, 256, params, seed=slots)
    assert got[2] == 8
    _assert_runs_bitwise(got, _biquad_run(biquad_step_plain, dev, 256, params, seed=slots))
    single = _per_slot(biquad_step, 48000)
    ref = _biquad_run(lambda st, p, x, fs: single(st, p, x), dev, 256, params, seed=slots)
    assert ref[2] == 8 * slots
    _assert_runs_bitwise(got, ref)


@pytest.mark.parametrize("ftype", range(7))
def test_biquad_step_glide_bitwise(dev, ftype):
    """40 consecutive blocks carrying state while the cutoff glides from 20
    Hz to 20 kHz at q 10 (near-unit poles at the bottom), +12 dB: every
    block's output and the final state bit-equal, one launch a block."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step, biquad_step_plain

    params = [{"filter_type": torch.tensor(float(ftype), device=dev),
               "cutoff_hz": torch.tensor(20.0 * 1000.0 ** (b / 39), device=dev),
               "q": torch.tensor(10.0, device=dev), "gain_db": torch.tensor(12.0, device=dev)}
              for b in range(40)]
    got = _biquad_run(biquad_step, dev, 256, params, seed=20 + ftype)
    ref = _biquad_run(biquad_step_plain, dev, 256, params, seed=20 + ftype)
    assert got[2] == 40 and ref[2] == 0
    _assert_runs_bitwise(got, ref)


def test_biquad_step_rejects_bad_operands(dev):
    """Operands of the wrong dtype, card or shape are refused before any
    launch."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step

    st = {"df1": torch.zeros((4, 2, 4), device=dev)}
    p = {k: torch.full((4,), v, device=dev) for k, v in
         (("filter_type", 0.0), ("cutoff_hz", 1000.0), ("q", 0.707), ("gain_db", 0.0))}
    x = torch.zeros((4, 2, 256), device=dev)
    bad = [
        ({"df1": st["df1"].double()}, p, x),
        ({"df1": st["df1"].cpu()}, p, x),
        ({"df1": st["df1"][:3]}, p, x),
        ({"df1": st["df1"].transpose(0, 1).contiguous().transpose(0, 1)}, p, x),
        (st, {**p, "q": p["q"].double()}, x),
        (st, {**p, "cutoff_hz": p["cutoff_hz"].cpu()}, x),
        (st, {**p, "gain_db": torch.zeros(8, device=dev)[::2]}, x),  # strided
        (st, {**p, "filter_type": torch.zeros(5, device=dev)}, x),
        (st, p, x.double()),
        (st, p, x.cpu()),
        (st, p, torch.zeros((4, 2, 1024), device=dev)),
    ]
    before = biquad_step.launches
    for args in bad:
        with pytest.raises(ValueError):
            biquad_step(*args, 48000)
    assert biquad_step.launches == before


@pytest.mark.parametrize("name,biquads", [("Multiband Master", 11), ("flagship", 1)])
def test_step_graph_replay_credits_biquad_step(dev, name, biquads):
    """One replay of the chain's captured step credits K5 once per biquad
    of the chain: the capture recorded that many launches."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.engine.flagship import FLAGSHIP
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step

    cfg = FLAGSHIP if name == "flagship" else DEFAULT_PRESETS[name]
    chain, state, tmap = build_chain(cfg, 48000, 256, channels_in=1, device=dev)
    chain.warmup(state, chain.targets(tmap))
    runner = chain.packed_step()
    assert runner.captured[2].get(biquad_step) == biquads
    before = biquad_step.launches
    runner.run()
    torch.cuda.synchronize()
    assert biquad_step.launches - before == biquads
    chain.release()


def test_file_render_credits_no_biquad_step(dev):
    """A file-mode render (18,000 samples, one call over the whole signal)
    takes the chunked Toeplitz solve and never launches K5."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.core.fileopts import file_static_overrides
    from aefs_tpu_torch.engine.flagship import FLAGSHIP
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step

    x = _noise_plus_tones(18000)[:, :1]
    for cfg in (DEFAULT_PRESETS["Multiband Master"], FLAGSHIP):
        chain, state, tmap = build_chain(cfg, 48000, 256, channels_in=1, device=dev,
                                         static_overrides=file_static_overrides(cfg))
        before = biquad_step.launches
        _, y = chain.process_array(state, chain.targets(tmap), x, fast=True)
        assert biquad_step.launches == before and np.all(np.isfinite(y))


@pytest.fixture(scope="module")
def dev1(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: launches on cuda:1 while cuda:0 is current")
    return torch.device("cuda", 1)


def test_biquad_step_launches_on_the_operands_card(dev1):
    """K5 on cuda:1 with cuda:0 current: the plain step's results (run with
    cuda:1 current) bit for bit, one launch a block, cuda:0 left current."""
    from aefs_tpu_torch.ops.kernels.biquad import biquad_step, biquad_step_plain

    params = [_biquad_grid(dev1, 4)] * 3
    with torch.cuda.device(dev1):
        ref = _biquad_run(biquad_step_plain, dev1, 256, params, 6)
    with torch.cuda.device(0):
        got = _biquad_run(biquad_step, dev1, 256, params, 6)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev1)
    assert got[2] == 3 and ref[2] == 0
    _assert_runs_bitwise(got, ref)


@pytest.mark.parametrize("kind", ["octaver_step", "chorus_step", "comb_sums"])
def test_kernels_launch_on_the_operands_card(dev1, kind):
    """A sharded step launches each kernel on its operands' card, whichever
    card is current: K1, K3 and K2 on cuda:1 with cuda:0 current give the
    results of their plain versions run with cuda:1 current (K1 and K3 bit
    for bit), one launch each, and leave cuda:0 current."""
    from aefs_tpu_torch.ops.kernels import comb, resample

    if kind == "comb_sums":
        c = 1408
        x, g, ht = _comb_operands(dev1, LAGS8, 2, 20000, 0.05)
        with torch.cuda.device(dev1):
            want = comb.comb_sums_plain(x, g, ht, LAGS8, c, REVERB_SIDES, 2)
        with torch.cuda.device(0):
            before = comb.comb_sums.launches
            got = comb.comb_sums(x, g, ht, LAGS8, c, REVERB_SIDES, 2, 0.05)
            assert comb.comb_sums.launches == before + 1
            assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(dev1)
        assert got[0].device == dev1
        assert float((got[0] - want[0]).abs().max()) < 1e-5
        assert float((got[1] - want[1]).abs().max()) < 1e-4
        return
    if kind == "octaver_step":
        run, step, plain, args = (_octaver_run, resample.octaver_step,
                                  resample.octaver_step_plain, (256, (-12.0,) * 3 + (-5.0,) * 3, 4))
    else:
        run, step, plain, args = (_chorus_run, resample.chorus_step,
                                  resample.chorus_step_plain, (256, (0.6,) * 3 + (4.0,) * 3, 5))
    with torch.cuda.device(dev1):
        ref = run(plain, dev1, *args)
    with torch.cuda.device(0):
        got = run(step, dev1, *args)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev1)
    assert got[2] == 6 and ref[2] == 0
    _assert_runs_bitwise(got, ref)


# --- K6: the flanger's line solve ------------------------------------------

FLANGER_JET = {"rate_hz": 0.25, "depth_ms": 2.0, "base_ms": 3.0, "feedback": 0.7, "mix": 0.5,
               "spread": 0.0}  # DEFAULT_PRESETS["Jet Flanger"]
FLANGER_NEGATIVE = {"rate_hz": 2.0, "depth_ms": 4.0, "base_ms": 1.0, "feedback": -0.7,
                    "mix": 1.0, "spread": 0.25}
FLANGER_DEEP = {"rate_hz": 1.3, "depth_ms": 5.0, "base_ms": 10.0, "feedback": 0.9, "mix": 0.7,
                "spread": 0.5}  # taps out to the history's far end
# name: (params, fs, file axis, frames) through Flanger.operands at the
# file's phases, or (None, history, (ca_lo, ca_hi), frames) for random
# operands (the "rows" cases with a feedback and a mix of their own a row).
K6_CASES = {
    "jet-demo-length": (FLANGER_JET, 48000, (), 892_928),
    "negative-spread": (FLANGER_NEGATIVE, 48000, (), 200_000),
    "files3": (FLANGER_JET, 48000, (3,), 100_000),
    "padded": (FLANGER_NEGATIVE, 48000, (), 100_003),
    "fs96k": (FLANGER_JET, 96000, (), 200_000),
    "fs96k-deep": (FLANGER_DEEP, 96000, (), 100_000),
    "random-reach": (None, 728, (24, 727), 100_000),
    "floor-random": (None, 100, (24, 99), 5_000),
    "rows-fb-mix": (None, 728, (24, 727), 100_000),
    "rows-at-floor": (None, 728, (24, 24), 4_096),
}


def _k6_operands(dev, case, seed=7):
    """flanger_file's operands: the flanger's own (noise input, a noise
    history, 2 channels) or random ones of a given reach."""
    from aefs_tpu_torch.models.flanger import Flanger

    params, fs, files, n = K6_CASES[case]
    rng = np.random.default_rng(seed)
    if params is None:
        h, (lo, hi) = fs, files
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        ca = torch.from_numpy(rng.integers(lo, hi + 1, (3, 2, n)).astype(np.int32)).to(dev)
        if case.startswith("rows"):  # the feedback one a file, the mix one a row
            fb, mix = f32([[0.7], [-0.6], [0.9]]), f32([[0.4, 1.0], [0.0, 0.3], [0.8, 0.5]])
        else:
            fb, mix = f32(0.7), f32(0.4)
        return (_noise(rng, (3, 2, n), dev), ca, f32(rng.uniform(-0.6, 1.2, (4, 3, 2, n))),
                fb, mix, _noise(rng, (3, 2, h), dev))
    mdl = Flanger(fs, 256, device=dev)
    p = {k: torch.tensor(float(v), device=dev) for k, v in params.items()}
    st = {k: v.expand(files + v.shape).clone() for k, v in mdl.init_state().items()}
    st["hist"] = _noise(rng, tuple(st["hist"].shape), dev)
    x = _noise(rng, files + (2, n), dev)
    xp, ca, w = mdl.operands(p, x, mdl.file_phases(st, p, n)[0])
    return xp, ca, w, p["feedback"], p["mix"], st["hist"]


@pytest.mark.parametrize("case", list(K6_CASES))
def test_flanger_file_kernel_matches_plain(dev, case):
    """K6 against its plain version on the card, bit for bit, y and v, in
    one launch: "Jet Flanger" at the demo's length, negative feedback with
    a channel spread, three files, a file padded to whole chunks, 96 kHz
    (H = 1,448) out to the history's far end, random taps over the whole
    history and at the floor (K6's stretches of 22), and a feedback and a
    mix of their own a row."""
    from aefs_tpu_torch.ops.kernels.flanger import flanger_file, flanger_file_plain

    ops = _k6_operands(dev, case)
    before = flanger_file.launches
    got = flanger_file(*ops)
    want = flanger_file_plain(*ops)
    torch.cuda.synchronize()
    assert flanger_file.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("signal,frames,bar", [
    ("tones", 6 * 4096, -90.0), ("noise", 6 * 4096, -90.0), ("noise", 262_144, -83.0),
], ids=["tones", "noise", "noise-long"])
def test_flanger_render_launches_k6_once_and_meets_the_reference(dev, signal, frames, bar):
    """A whole-file "Jet Flanger" render on the card: one K6 launch, and
    within -90 dBFS of the benchmark's float64 reference on the signals of
    tests/test_torch_flanger_reference.py (the port's own bar there); on
    262,144 samples of white noise within -83, the level the float32
    delay's rounding sets there, whatever the solve (that file's
    LONG_NOISE_DBFS); a batched render of three files: one launch too."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.engine.engine import render_batch
    from aefs_tpu_torch.ops.kernels.flanger import flanger_file
    from benchmark.reference import flanger as ref
    from helpers import noise, tones

    x = {"tones": tones, "noise": noise}[signal](frames)
    chain, state, tmap = build_chain([{"effect_id": "f", "type": "flanger",
                                       "params": FLANGER_JET}], 48000, 4096, channels_in=2,
                                     device=dev)
    before = flanger_file.launches
    got = chain.process_array(state, chain.targets(tmap), x, fast=True)[1]
    assert flanger_file.launches == before + 1
    want = ref.apply(x.T.astype(np.float64), {**ref.DEFAULTS, **FLANGER_JET}, 48000).T
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert 20.0 * np.log10(err) <= bar, err
    before = flanger_file.launches
    render_batch(DEFAULT_PRESETS["Jet Flanger"], [x[:20_000], x[:16_000], x[5:18_000]],
                 48000, device="cuda")
    assert flanger_file.launches == before + 1


def test_flanger_file_rejects_bad_card_operands(dev):
    """Operands on another device, strided, of a length off the 4-sample
    grid or off a 16-byte boundary are refused before any launch."""
    from aefs_tpu_torch.ops.kernels.flanger import flanger_file

    x, ca, w, fb, mix, hist = _k6_operands(dev, "floor-random")
    bad = [
        (x.cpu(), ca, w, fb, mix, hist),
        (x, ca.cpu(), w, fb, mix, hist),
        (x, ca, w, fb.cpu(), mix, hist),
        (x, ca, w, fb.expand(3), mix, hist),  # not one a file or a row
        (x, ca, w, fb, mix, hist.cpu()),
        (x.transpose(-1, -2).contiguous().transpose(-1, -2), ca, w, fb, mix, hist),
        (x, ca, w.transpose(1, 2).contiguous().transpose(1, 2), fb, mix, hist),
        (x, ca, w, fb, mix, torch.zeros((3, 2, 200), device=dev)[..., :100]),  # rows apart
        (x[..., :-1].contiguous(), ca[..., :-1].contiguous(), w[..., :-1].contiguous(), fb,
         mix, hist),
        (torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x), ca, w, fb, mix,
         hist),
        (x, torch.empty(ca.numel() + 2, dtype=ca.dtype, device=dev)[2:].view(ca.shape), w, fb,
         mix, hist),
    ]
    before = flanger_file.launches
    for args in bad:
        with pytest.raises(ValueError):
            flanger_file(*args)
    assert flanger_file.launches == before
