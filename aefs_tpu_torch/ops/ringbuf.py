"""Chronological ring buffers and blocked delay-line solvers (port of
aefs_tpu/ops/ringbuf.py).

Every buffer is chronological: ``hist[..., -1]`` is the newest sample and
a block update is one ``cat(hist, new)[..., -S:]``.  The delay's long line
is a block-row ring (one row per block) whose row pointer is an int32
counter.  Reads at runtime distances are gathers on index tensors, so no
value ever crosses back to the host inside a block.

The comb kernels' entries live here with the reference's contracts:
``comb_bank_file_sums`` (whole-file reverb comb sums, kernel K2) and
``comb_bank_file_chunks`` / ``comb_bank_file`` (the comb bank with every
chunk's outputs, kernel K4), both through ``ops/kernels``.  The tap read
``fractional_read_cubic`` is the plain piece of kernels K1 and K3, which
the octaver and the chorus call as whole block steps
(``ops/kernels/resample.py``).
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.ops.scan import _shift, const_affine_hillis, lag_affine_scan


def ring_push(hist, new):
    """Append ``new`` (time-last) and keep the trailing window of hist's size."""
    size = hist.shape[-1]
    return torch.cat([hist, new], -1)[..., -size:]


def _take_last(v, idx):
    """v[..., idx[..., j]] — a gather along the last axis (idx broadcast)."""
    idx = torch.broadcast_to(idx, v.shape[:-1] + idx.shape[-1:])
    return torch.gather(v, -1, idx)


def rowring_rows(size: int, blocksize: int) -> int:
    """Row count for a block-row ring covering reads up to ``size`` back."""
    return -(-size // blocksize) + 1


def rowring_read(ring, row, d, n: int):
    """Window of ``n`` samples starting ``d`` samples before the current
    block, from a block-row ring.

    ring: (..., R, N) — row ``row`` is the slot the CURRENT block will
      occupy, row ``row - 1`` (mod R) holds the previous block.
    row: int32 0-dim; d: int (...,) distances in [1, (R-1)*N].  Lanes
      j >= d depend on the unwritten current block — callers mask them.

    The flattened ring is chronological modulo R*N, so the window is one
    gather at (row*N - d + j) mod R*N."""
    r, nn = ring.shape[-2:]
    assert nn == n
    j = torch.arange(n, device=ring.device)
    start = row.long() * n - d.long()
    idx = torch.remainder(start[..., None] + j, r * n)
    return _take_last(ring.reshape(*ring.shape[:-2], r * n), idx)


def rowring_write(ring, row, blk):
    """Write ``blk`` (..., N) into slot ``row`` of a block-row ring
    (returns a new ring; the state tree stays functional)."""
    return ring.index_copy(-2, row.reshape(1).long(), blk[..., None, :])


def _shift_dyn(y, d):
    """y[..., n - d] with zeros for n < d; ``d`` an int tensor (...)."""
    n = y.shape[-1]
    idx = torch.arange(n, device=y.device) - d.long()[..., None]
    out = _take_last(y, idx.clamp(min=0))
    return torch.where(idx >= 0, out, torch.zeros((), device=y.device))


def _feedback_solve(x, base_hist, in_hist, d, feedback, k: int):
    """Solve y[n] = (base_hist[n] if n < d else x[n-d] + fb*y[n-d]) by
    geometric doubling of the affine fixed point: with zero-filling shifts
    S_m, y = sum_j fb^j S_{j*d} c, c = where(n < d, base_hist, x[n-d]), and
    P_{2m} = P_m + fb^m S_{m*d} P_m."""
    n = x.shape[-1]
    zero = torch.zeros((), device=x.device)
    if k <= 1:
        return torch.where(in_hist, base_hist, zero)
    c = torch.where(in_hist, base_hist, _shift_dyn(x, d))
    y = c
    m = 1
    amp = feedback
    while m < k:
        shift = torch.clamp(m * d, max=n)  # shifts past the block are 0
        y = y + amp * _shift_dyn(y, shift)
        amp = amp * amp
        m *= 2
    return y


def feedback_delay_block_rows(ring, row, x, d_samples, feedback, min_delay: int,
                              n_iters: int | None = None):
    """Feedback echo over one block on a block-row ring (port of
    delay_kernel, reference delay.py:7-22):

        y[n] = w[n - d],   w[n] = x[n] + feedback * y[n]

    ring: (..., R, N) written values w; row: shared int32 slot;
    x: (..., N); d_samples: int (...) in [min_delay, (R-1)*N]; feedback
    0-dim or broadcastable to x.
    n_iters: fixed-point pass count, default ceil(N / min_delay).
    Returns (y, new_ring) — the caller advances the row pointer."""
    n = x.shape[-1]
    base_hist = rowring_read(ring, row, d_samples, n)
    in_hist = torch.arange(n, device=x.device) < d_samples.long()[..., None]
    k = n_iters or max(1, -(-n // max(1, min_delay)))
    y = _feedback_solve(x, base_hist, in_hist, d_samples, feedback, k)
    w = x + feedback * y
    return y, rowring_write(ring, row, w)


def delay_read(hist, x, d_samples):
    """Pure delay: y[n] = stream[n - d], stream = hist ++ x.

    hist: (..., S); x: (..., N); d_samples: int tensor broadcastable to
    (...) in [0, S].  Returns y: (..., N)."""
    s = hist.shape[-1]
    n = x.shape[-1]
    ext = torch.cat([hist, x], -1)
    idx = (s - d_samples.long())[..., None] + torch.arange(n, device=x.device)
    return _take_last(ext, idx)


def comb_bank_block(hists, lps, x, lag_t, g, h, min_lag: int):
    """A bank of damped feedback combs sharing one input, for blocks
    longer than the shortest lag (fixed point: corrections propagate one
    lag per pass).

    hists: (..., B, Lmax) padded chronological windows; lps: (..., B)
    damping states; x: (..., N) shared or (..., B, N) per-comb input;
    lag_t: the static lags (B,) as an integer tensor on x's device (made
    once by the caller: a captured step cannot upload them); g: (..., B);
    h: 0-dim or (..., 1, 1).  Returns (y, new_hists, new_lps)."""
    b, lmax = hists.shape[-2:]
    n = x.shape[-1]
    shape = hists.shape[:-1] + (n,)
    ext = torch.cat([hists, torch.zeros(shape, device=x.device)], -1)
    base_hist = _take_last(ext, (lmax - lag_t)[:, None]
                           + torch.arange(n, device=x.device))  # valid where n < lag
    in_hist = torch.arange(n, device=x.device)[None, :] < lag_t[:, None]
    xb = torch.broadcast_to(x, shape)
    x_shift = _shift_dyn(xb, lag_t)
    lps_col = lps[..., None]
    g_col = g[..., None]
    k = max(1, -(-n // max(1, min_lag)))
    y = torch.zeros(shape, device=x.device)
    for _ in range(k):
        damped = const_affine_hillis(h, (1.0 - h) * y, lps_col)
        y = torch.where(in_hist, base_hist, x_shift + g_col * _shift_dyn(damped, lag_t))
    damped = const_affine_hillis(h, (1.0 - h) * y, lps_col)
    w = xb + g_col * damped
    new_hists = torch.cat([hists, w], -1)[..., -lmax:]
    return y, new_hists, damped[..., -1]


def comb_bank_block_static(hists, lps, x, lags, g, h):
    """Streaming comb bank for blocks no longer than the shortest lag
    (always true at mic blocksizes): every lag-L read predates the block,
    so the outputs are static per-comb history windows, and the damping
    recurrence is a constant-coefficient Hillis prefix.

    hists: (..., B, Lmax); lps: (..., B); x: (..., N) shared or
    (..., B, N); lags: static ints; g: (..., B); h: 0-dim or (..., 1, 1).
    Returns (y, new_hists, new_lps)."""
    b, lmax = hists.shape[-2:]
    n = x.shape[-1]
    lags = tuple(int(l) for l in lags)
    assert n <= min(lags), (n, lags)
    xb = torch.broadcast_to(x, hists.shape[:-1] + (n,))
    y = torch.stack([hists[..., c, lmax - lag : lmax - lag + n] for c, lag in enumerate(lags)],
                    -2)
    damped = const_affine_hillis(h, (1.0 - h) * y, lps[..., None])
    w = xb + g[..., None] * damped
    new_hists = torch.cat([hists, w], -1)[..., -lmax:]
    return y, new_hists, damped[..., -1]


def comb_chunk_size(lags, chunk=None) -> int:
    """``chunk`` when given, else the largest 128-aligned chunk C with
    C <= L < 2C for every lag, else min(lags); raises if the chunk does
    not satisfy it."""
    if chunk:
        c = int(chunk)
    else:
        c = (min(lags) // 128) * 128
        if not c or not all(c <= lag < 2 * c for lag in lags):
            c = min(lags)
    if not all(c <= lag < 2 * c for lag in lags):
        raise ValueError(f"comb lags {lags} violate C <= L < 2C for C={c}")
    return c


def comb_bank_file_sums(x, lags, g, h, side_of, n_sides: int, h_static=None):
    """Whole-signal damped comb bank from fresh state, reduced to what the
    reverb's file path reads (kernel K2, ops/kernels/comb.py):

        y_b[n]      = x[side_of[b], n - L_b] + g_b * damped_b[n - L_b]
        damped_b[n] = h * damped_b[n-1] + (1 - h) * y_b[n]

    in chunks of C (C <= L_b < 2C).  x: (S, N), or (F, S, N) for F files
    sharing g and h (one launch for all of them); lags/side_of: static
    ints; g: (B,); h: 0-dim; h_static: the baked damping (file mode) that
    lets the kernel truncate the damping to an exact FIR.

    Returns (ysum (n_sides, M, C) per-side comb sums, d_tail (3, B, C) the
    damped state of the last three chunks — leading rows zero for shorter
    signals — and C); with a file axis, each with a leading F."""
    from aefs_tpu_torch.ops.kernels.comb import comb_sums

    c = comb_chunk_size(lags)
    ysum, d_tail = comb_sums(x, g, h, tuple(int(l) for l in lags), c,
                             tuple(side_of), n_sides, h_static)
    return ysum, d_tail, c


def comb_bank_file_chunks(x, lags, g, h, chunk=None, side_of=None):
    """Whole-signal damped comb bank from fresh state, in chunk-major form
    (kernel K4, ops/kernels/comb.py): the recursion of
    ``comb_bank_file_sums`` with every comb's output kept.

    x: (S, N) raw source signals; comb b reads ``x[side_of[b]]`` at lag
    ``lags[b]`` (``side_of`` defaults to the identity, S == B); g: (B,);
    h: 0-dim traced damping; chunk: C, by default the reference's rule
    (``comb_chunk_size``).

    Returns (y, damped) as (M, B, C) chunk tensors (N padded to M*C) and C."""
    from aefs_tpu_torch.ops.kernels.comb import comb_chunks

    lags = tuple(int(l) for l in lags)
    side_of = tuple(range(len(lags))) if side_of is None else tuple(side_of)
    c = comb_chunk_size(lags, chunk)
    y, damped = comb_chunks(x, g, h, lags, c, side_of)
    return y, damped, c


def comb_bank_file(x, lags, g, h, chunk=None):
    """``comb_bank_file_chunks`` flattened: x (B, N) per-comb input ->
    (y, damped), each (B, N)."""
    y_mbc, d_mbc, _ = comb_bank_file_chunks(x, lags, g, h, chunk)
    b, n = x.shape
    y = y_mbc.movedim(0, 1).reshape(b, -1)[:, :n]
    damped = d_mbc.movedim(0, 1).reshape(b, -1)[:, :n]
    return y, damped


def allpass_block(hist, x, a, lag: int):
    """Gardner/Moorer allpass diffuser over one block (port of
    allpass_kernel, reference reverb.py:48-67):

        y[n] = w[n - lag] - a*x[n],   w[n] = x[n] + a*y[n]

    i.e. y[n] = base[n] + a*y[n - lag] with
    base[n] = (hist[n] if n < lag else x[n - lag]) - a*x[n].
    hist: (..., lag) chronological written values; x: (..., N).  Returns
    (y, new_hist)."""
    n = x.shape[-1]
    if n <= lag:
        y = hist[..., :n] - a * x
    else:
        head = hist - a * x[..., :lag]
        tail = x[..., : n - lag] - a * x[..., lag:]
        base = torch.cat([head, tail], -1)
        k = (n - 1) // lag  # highest feedback order reaching into the block
        if k <= 8:
            # Streaming blocks: y = sum_j a^j base[n - j*lag] as Horner steps.
            y = base
            for _ in range(k):
                y = base + a * _shift(y, lag)
        else:
            y = lag_affine_scan(base, a, lag)
    w = x + a * y
    return y, ring_push(hist, w)


def cubic_hermite(frac, y0, y1, y2, y3):
    """4-point Hermite interpolation (reference octaver.py:9-15).  The
    step kernels' tap read (csrc/tap_read.cuh) repeats this operation order."""
    c0 = y1
    c1 = 0.5 * (y2 - y0)
    c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    return ((c3 * frac + c2) * frac + c1) * frac + c0


def cubic_tap_weights(fr):
    """4-point cubic-Hermite (Catmull-Rom) tap weights at fraction ``fr``:
    the basis polynomials ``cubic_hermite`` evaluates, for callers that
    hold the weights and the tap positions apart (the flanger's line
    solve)."""
    w0 = fr * (-0.5 + fr * (1.0 - 0.5 * fr))
    w1 = 1.0 + fr * fr * (-2.5 + 1.5 * fr)
    w2 = fr * (0.5 + fr * (2.0 - 1.5 * fr))
    w3 = fr * fr * (0.5 * fr - 0.5)
    return w0, w1, w2, w3


def fractional_read_cubic(hist, x, ago):
    """Cubic-interpolated tap at fractional distances ``ago`` (..., N) into
    the past of the stream hist (..., S) ++ x (..., N): the four samples
    ca+1 .. ca-2 back (ca = ceil(ago)), interpolated at frac = ca - ago,
    with the reference's ring-wrap semantics on the boundary lanes
    (reference octaver.py:37-62).  Leading axes are independent streams."""
    s = hist.shape[-1]
    n = x.shape[-1]
    ext = torch.cat([hist, x], -1)
    ca_f = torch.ceil(ago)
    frac = ca_f - ago
    ca = ca_f.to(torch.int32)
    base = s + torch.arange(n, device=x.device, dtype=torch.int32)
    start = torch.clamp(base - (ca + 1), 0, s + n - 4).long()
    taps = [torch.gather(ext, -1, start + k) for k in range(4)]
    bulk = cubic_hermite(frac, *taps)
    return _wrap_patch(ext, s, n, ca, frac, bulk)


def _wrap_patch(ext, s, n, ca, frac, bulk):
    """Overwrite the ring-boundary lanes with the reference's wrap
    semantics (octaver.py:45-48): when ca is within 1 of the ring boundary,
    the wrapped distances land in {0, 1, 2} or {s-3, s-2, s-1}, whose
    reads are static shifts of the stream."""
    shifts = {j: ext[..., s - j : s - j + n] for j in (0, 1, 2, s - 3, s - 2, s - 1)}

    def wrap_tap(offset):
        back = torch.remainder(ca + offset, s)
        out = shifts[0]
        for j in (1, 2, s - 3, s - 2, s - 1):
            out = torch.where(back == j, shifts[j], out)
        return out

    needs_wrap = (ca <= 1) | (ca >= s - 1)
    wrapped = cubic_hermite(frac, wrap_tap(1), wrap_tap(0), wrap_tap(-1), wrap_tap(-2))
    return torch.where(needs_wrap, wrapped, bulk)
