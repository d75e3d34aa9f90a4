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


def _ramps(size, n, step_scale, p0, rng):
    hist = (0.3 * rng.standard_normal(size)).astype(np.float32)
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    p1 = np.mod(p0 + np.arange(n) * (step_scale / size), 1.0).astype(np.float32)
    p2 = np.mod(p1 + 0.5, 1.0).astype(np.float32)
    return hist, x, (p1 * size).astype(np.float32), (p2 * size).astype(np.float32)


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("step_scale", [-0.94, -0.5, 0.3, 0.9])
def test_octaver_taps_kernel_matches_plain(dev, n, step_scale):
    from aefs_tpu_torch.ops.kernels.resample import octaver_taps, octaver_taps_plain

    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a).to(dev) for a in _ramps(1920, n, step_scale, 0.37, rng)]
    before = octaver_taps.launches
    s1, s2 = octaver_taps(*args)
    torch.cuda.synchronize()
    assert octaver_taps.launches == before + 1
    r1, r2 = octaver_taps_plain(*args)
    for got, ref in ((s1, r1), (s2, r2)):
        assert float((got - ref).abs().max()) <= 2e-6


def test_octaver_taps_wrap_lanes(dev):
    """Distances within one sample of the ring boundary (the wrap lanes)."""
    from aefs_tpu_torch.ops.kernels.resample import octaver_taps, octaver_taps_plain

    size, n = 1920, 256
    rng = np.random.default_rng(8)
    hist = torch.from_numpy((0.3 * rng.standard_normal(size)).astype(np.float32)).to(dev)
    x = torch.from_numpy((0.3 * rng.standard_normal(n)).astype(np.float32)).to(dev)
    edge = np.concatenate([np.linspace(0.0, 2.5, n // 2),
                           np.linspace(size - 2.5, size - 1e-3, n // 2)]).astype(np.float32)
    ago1 = torch.from_numpy(edge).to(dev)
    ago2 = torch.from_numpy(edge[::-1].copy()).to(dev)
    s1, s2 = octaver_taps(hist, x, ago1, ago2)
    r1, r2 = octaver_taps_plain(hist, x, ago1, ago2)
    assert float((s1 - r1).abs().max()) <= 2e-6
    assert float((s2 - r2).abs().max()) <= 2e-6


def test_octaver_taps_rejects_bad_operands(dev):
    from aefs_tpu_torch.ops.kernels.resample import octaver_taps

    z = torch.zeros(256, device=dev)
    with pytest.raises(ValueError):
        octaver_taps(torch.zeros(1920, device=dev, dtype=torch.float64), z, z, z)
    with pytest.raises(ValueError):
        octaver_taps(torch.zeros(1920, device=dev), z, z, torch.zeros(128, device=dev))


@pytest.mark.parametrize("fs,blocksize,fast", [(16000, 4096, True), (48000, 200, False)],
                         ids=["16k-file-plus7", "48k-block200"])
def test_octaver_launches_k1_at_any_geometry(dev, fs, blocksize, fast):
    """The octaver launches K1 for every generic block, also where the
    reference's TPU tile rule reads with the plain gather (a 640-sample
    ring at 16 kHz; blocks that are no multiple of 128), and the card
    renders what the CPU port renders."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.fileopts import file_static_overrides
    from aefs_tpu_torch.ops.kernels.resample import octaver_taps

    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": 7, "mix": 0.5}}]
    blocks = 3 if fast else 8
    x = (0.25 * np.random.default_rng(9).standard_normal((blocks * blocksize, 2))).astype(np.float32)
    outs, launched = {}, {}
    for d in ("cuda", "cpu"):
        statics = file_static_overrides(cfg) if fast else None
        chain, state, tmap = build_chain(cfg, fs, blocksize, channels_in=2,
                                         static_overrides=statics, device=d)
        before = octaver_taps.launches
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x, fast=fast)
        launched[d] = octaver_taps.launches - before
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


def _chorus_rows(dev, n, seed):
    """Two rows at the chorus's geometry (history 2408) with chorus-law
    distances, plus two rows whose distances cross the ring boundary."""
    rng = np.random.default_rng(seed)
    hist = (0.3 * rng.standard_normal((2, 2408))).astype(np.float32)
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    ph = 0.13 + np.arange(n) * (0.6 / 48000.0) + 0.25 * np.arange(2)[:, None]
    ago = np.clip((14.0 + 4.0 * np.sin(2 * np.pi * ph)) * 48.0, 2.0, 2406.0).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (hist, x, ago)]


@pytest.mark.parametrize("n", [256, 892800])
def test_fractional_read_kernel_matches_plain_bitwise(dev, n):
    """K3 against its plain version, bit for bit, at the chorus's streaming
    block and at the demo file's length (2 x 892,800 outputs)."""
    from aefs_tpu_torch.ops.kernels.resample import fractional_read, fractional_read_plain

    args = _chorus_rows(dev, n, seed=n)
    before = fractional_read.launches
    got = fractional_read(*args)
    torch.cuda.synchronize()
    assert fractional_read.launches == before + 1
    assert torch.equal(got, fractional_read_plain(*args))


def test_fractional_read_kernel_wrap_lanes_bitwise(dev):
    from aefs_tpu_torch.ops.kernels.resample import fractional_read, fractional_read_plain

    size, n = 1920, 256
    rng = np.random.default_rng(10)
    hist = torch.from_numpy((0.3 * rng.standard_normal((2, size))).astype(np.float32)).to(dev)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, n))).astype(np.float32)).to(dev)
    edge = np.concatenate([np.linspace(0.0, 2.5, n // 2),
                           np.linspace(size - 2.5, size - 1e-3, n // 2)]).astype(np.float32)
    ago = torch.from_numpy(np.stack([edge, edge[::-1].copy()])).to(dev)
    assert torch.equal(fractional_read(hist, x, ago), fractional_read_plain(hist, x, ago))


def test_fractional_read_rejects_bad_operands(dev):
    from aefs_tpu_torch.ops.kernels.resample import fractional_read

    hist, x, ago = _chorus_rows(dev, 256, seed=1)
    with pytest.raises(ValueError):
        fractional_read(hist, x, ago[:, :128])
    with pytest.raises(ValueError):
        fractional_read(hist, x.T.contiguous().T, ago)  # not contiguous
    with pytest.raises(ValueError):
        fractional_read(hist.double(), x, ago)


def test_chorus_streaming_step_launches_k3_once_per_block(dev):
    """The chorus reads through K3 on the card: one launch per block (both
    channels), never the plain gather, and renders what the CPU renders."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS
    from aefs_tpu_torch.ops.kernels.resample import fractional_read

    cfg = DEFAULT_PRESETS["Lush Chorus"]
    x = (0.25 * np.random.default_rng(11).standard_normal((12 * 256, 1))).astype(np.float32)
    outs, launched = {}, {}
    for d in ("cuda", "cpu"):
        chain, state, tmap = build_chain(cfg, 48000, 256, channels_in=1, device=d)
        before = fractional_read.launches
        _, outs[d] = chain.process_array(state, chain.targets(tmap), x)
        launched[d] = fractional_read.launches - before
    assert launched == {"cuda": 12, "cpu": 0}
    err = float(np.max(np.abs(outs["cuda"].astype(np.float64) - outs["cpu"])))
    assert err == 0.0 or 20.0 * np.log10(err) <= -90.0, err


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
