"""Kernel K2's plain version (whole-file reverb comb sums) against the JAX
package's ``comb_bank_file_sums``, through its XLA fallback and its Pallas
kernel in interpret mode, at the JAX kernel tests' bars (max abs 1e-5 on
the sums, 1e-4 on the damped tail)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.ops.pallas.comb import fir_damp_weights as jax_fir_weights
from aefs_tpu.ops.ringbuf import comb_bank_file_sums as jax_sums
from aefs_tpu_torch.ops.kernels.comb import comb_sums, fir_damp_weights
from aefs_tpu_torch.ops.ringbuf import comb_bank_file_sums

# The flagship reverb's jittered lags at 48 kHz (both sides, 4 combs each).
LAGS = (1425, 1780, 1972, 2097, 1411, 1766, 1958, 2083)
SIDE_OF = (0, 0, 0, 0, 1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _compare(n, h, h_static, use_pallas, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    g = np.linspace(0.5, 0.9, 8).astype(np.float32)
    ysum, d_tail, c = comb_bank_file_sums(
        torch.from_numpy(x), LAGS, torch.from_numpy(g),
        torch.tensor(h, dtype=torch.float32), SIDE_OF, 2, h_static=h_static)
    y_ref, d_ref, c_ref = jax_sums(
        jnp.asarray(x), LAGS, jnp.asarray(g), jnp.float32(h), SIDE_OF, 2,
        use_pallas=use_pallas, h_static=h_static)
    assert c == c_ref == 1408
    assert ysum.shape == y_ref.shape and d_tail.shape == d_ref.shape == (3, 8, c)
    assert float(np.max(np.abs(ysum.numpy() - np.asarray(y_ref)))) < 1e-5
    assert float(np.max(np.abs(d_tail.numpy() - np.asarray(d_ref)))) < 1e-4


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
@pytest.mark.parametrize("h,h_static", [(0.05, 0.05), (0.2, 0.2), (0.6, None)])
def test_plain_sums_match_jax(use_pallas, h, h_static):
    """n = 20000 (15 chunks): FIR damping at h_static 0.05 / 0.2, the
    log-step scan at h = 0.6."""
    _compare(20000, h, h_static, use_pallas, seed=3)


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
@pytest.mark.parametrize("n", [900, 1500, 2900])
def test_plain_sums_short_signal(use_pallas, n):
    """Fewer than three chunks: the leading damped-tail rows stay zero."""
    _compare(n, 0.3, None, use_pallas, seed=n)


@pytest.mark.parametrize("h", [0.0, 0.05, 0.2, 0.40, 0.41, 0.6, 0.99, 1.0])
def test_fir_damp_weights_match_jax(h):
    ours, ref = fir_damp_weights(h), jax_fir_weights(h)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert np.array_equal(np.asarray(ours), np.asarray(ref))


@pytest.mark.parametrize("h_static", [None, 0.0, 0.05, 0.2, 0.40, 0.41, 0.99])
def test_fir_kernel_weights(h_static):
    """The kernel's by-value damping argument: JAX's FIR taps bit for bit,
    zero-padded to 32; no taps (the scan) for None and past the budget."""
    from aefs_tpu_torch.ops.kernels.comb import fir_kernel_weights

    w, n_taps = fir_kernel_weights(h_static)
    assert w.dtype == np.float32 and w.shape == (32,)
    ref = None if h_static is None else jax_fir_weights(h_static)
    if ref is None:
        assert n_taps == 0 and not w.any()
    else:
        assert n_taps == len(ref)
        assert np.array_equal(w[:n_taps], np.asarray(ref, np.float32))
        assert not w[n_taps:].any()
    assert (n_taps == 0) == (h_static is None or h_static > 0.40)


def test_plain_sums_on_cpu_do_not_count_launches():
    x = torch.zeros((2, 3000))
    before = comb_sums.launches
    comb_sums(x, torch.full((8,), 0.5), torch.tensor(0.3), LAGS, 1408, SIDE_OF, 2)
    assert comb_sums.launches == before


# --- Kernel K4: the comb bank with every chunk's y and damped ---------------

from aefs_tpu.ops.ringbuf import comb_bank_file as jax_comb_file
from aefs_tpu.ops.ringbuf import comb_bank_file_chunks as jax_chunks
from aefs_tpu_torch.ops.kernels.comb import comb_chunks, comb_chunks_plain
from aefs_tpu_torch.ops.ringbuf import comb_bank_file, comb_bank_file_chunks, comb_chunk_size


def _k4_inputs(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((rows, n))).astype(np.float32)
    return x, np.linspace(0.5, 0.9, 8).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
@pytest.mark.parametrize("sides", ["identity", "reverb"])
def test_chunks_match_jax(use_pallas, sides):
    """``comb_bank_file_chunks`` against the JAX package's (its XLA solve and
    its Pallas kernel in interpret mode), n = 20000 (15 chunks of 1408), at
    the JAX kernel tests' bar: max abs 1e-5 on y and on damped."""
    side_of = None if sides == "identity" else SIDE_OF
    x, g = _k4_inputs(8 if side_of is None else 2, 20000, seed=5)
    h = 0.3
    y, d, c = comb_bank_file_chunks(torch.from_numpy(x), LAGS, torch.from_numpy(g),
                                    torch.tensor(h), side_of=side_of)
    y_ref, d_ref, c_ref = jax_chunks(jnp.asarray(x), LAGS, jnp.asarray(g), jnp.float32(h),
                                     use_pallas=use_pallas, side_of=side_of)
    assert c == c_ref == 1408 and y.shape == y_ref.shape == (15, 8, 1408)
    assert float(np.max(np.abs(y.numpy() - np.asarray(y_ref)))) < 1e-5
    assert float(np.max(np.abs(d.numpy() - np.asarray(d_ref)))) < 1e-5


@pytest.mark.parametrize("chunk", [None, 1411])
def test_comb_bank_file_matches_jax(chunk):
    """The flattened (B, N) form, with the default chunk rule and an
    explicit chunk."""
    x, g = _k4_inputs(8, 6000, seed=6)
    y, d = comb_bank_file(torch.from_numpy(x), LAGS, torch.from_numpy(g),
                          torch.tensor(0.6), chunk=chunk)
    y_ref, d_ref = jax_comb_file(jnp.asarray(x), LAGS, jnp.asarray(g), jnp.float32(0.6),
                                 chunk=chunk, use_pallas=False)
    assert y.shape == d.shape == (8, 6000)
    assert float(np.max(np.abs(y.numpy() - np.asarray(y_ref)))) < 1e-5
    assert float(np.max(np.abs(d.numpy() - np.asarray(d_ref)))) < 1e-5


def test_sums_plain_is_the_chunk_loop_reduced():
    """K2's plain version is K4's loop plus the side sums and the tail."""
    x, g = _k4_inputs(2, 9000, seed=7)
    xt, gt, ht = torch.from_numpy(x), torch.from_numpy(g), torch.tensor(0.4)
    y, d = comb_chunks_plain(xt, gt, ht, LAGS, 1408, SIDE_OF)
    ysum, d_tail = comb_sums(xt, gt, ht, LAGS, 1408, SIDE_OF, 2)
    assert torch.equal(ysum[0], y[:, 0] + y[:, 1] + y[:, 2] + y[:, 3])
    assert torch.equal(ysum[1], y[:, 4] + y[:, 5] + y[:, 6] + y[:, 7])
    assert torch.equal(d_tail, d[-3:])


def test_chunk_rule_matches_jax():
    assert comb_chunk_size(LAGS) == 1408
    assert comb_chunk_size(LAGS, 1411) == 1411
    for bad in (1000, 2098):
        with pytest.raises(ValueError, match="violate"):
            comb_chunk_size(LAGS, bad)
        with pytest.raises(ValueError, match="violate"):
            jax_chunks(jnp.zeros((8, 3000)), LAGS, jnp.ones(8), jnp.float32(0.3),
                       chunk=bad, use_pallas=False)


def test_chunks_on_cpu_do_not_count_launches():
    before = comb_chunks.launches
    comb_chunks(torch.zeros((8, 3000)), torch.full((8,), 0.5), torch.tensor(0.3),
                LAGS, 1408, tuple(range(8)))
    assert comb_chunks.launches == before


@pytest.mark.parametrize("h,h_static", [(0.05, 0.05), (0.6, None)], ids=["fir", "scan"])
def test_plain_sums_file_axis_bitwise(h, h_static):
    """K2's plain version over x (F, S, N), F = 3: each file bit-equal to
    its F = 1 call; the entry returns (F, ...) sums and tails and is held
    to JAX's per file at the kernel tests' bars."""
    from aefs_tpu_torch.ops.kernels.comb import comb_sums_plain

    rng = np.random.default_rng(9)
    x = (0.3 * rng.standard_normal((3, 2, 5000))).astype(np.float32)
    g = torch.from_numpy(np.linspace(0.5, 0.9, 8).astype(np.float32))
    ht = torch.tensor(h, dtype=torch.float32)
    ysum, d_tail = comb_sums_plain(torch.from_numpy(x), g, ht, LAGS, 1408, SIDE_OF, 2)
    assert ysum.shape == (3, 2, 4, 1408) and d_tail.shape == (3, 3, 8, 1408)
    for f in range(3):
        y1, d1 = comb_sums_plain(torch.from_numpy(x[f]), g, ht, LAGS, 1408, SIDE_OF, 2)
        assert torch.equal(ysum[f], y1) and torch.equal(d_tail[f], d1), f
    ys, ds, c = comb_bank_file_sums(torch.from_numpy(x), LAGS, g, ht, SIDE_OF, 2,
                                    h_static=h_static)
    assert c == 1408 and torch.equal(ys, ysum) and torch.equal(ds, d_tail)
    y_ref, d_ref, _ = jax_sums(jnp.asarray(x[2]), LAGS, jnp.asarray(g.numpy()), jnp.float32(h),
                               SIDE_OF, 2, use_pallas=False, h_static=h_static)
    assert float(np.max(np.abs(ys[2].numpy() - np.asarray(y_ref)))) < 1e-5
    assert float(np.max(np.abs(ds[2].numpy() - np.asarray(d_ref)))) < 1e-4


def test_plain_chunks_file_axis_bitwise():
    """K4's plain version over x (F, S, N): each file bit-equal to its
    F = 1 call, (F, M, B, C) outputs."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks_plain

    rng = np.random.default_rng(10)
    x = torch.from_numpy((0.3 * rng.standard_normal((3, 2, 4300))).astype(np.float32))
    g = torch.from_numpy(np.linspace(0.5, 0.9, 8).astype(np.float32))
    h = torch.tensor(0.3)
    y, d = comb_chunks_plain(x, g, h, LAGS, 1408, SIDE_OF)
    assert y.shape == d.shape == (3, 4, 8, 1408)
    for f in range(3):
        y1, d1 = comb_chunks_plain(x[f], g, h, LAGS, 1408, SIDE_OF)
        assert torch.equal(y[f], y1) and torch.equal(d[f], d1), f
