"""Blocked linear-recurrence solvers (port of aefs_tpu/ops/scan.py).

Every IIR recurrence of the effects is solved for a whole block at once:

- first-order affine  y[n] = m[n]*y[n-1] + b[n]  -> ``affine_hillis`` /
  ``affine_scan_long`` (log-depth Hillis-Steele span doubling);
- constant coefficient  y[n] = h*y[n-1] + b[n]  -> ``const_affine_hillis``;
- lag-L  y[n] = b[n] + a*y[n-L]  -> ``lag_affine_scan`` (residue-class rows,
  one Toeplitz matmul per row chunk plus a carry scan);
- second order (biquad)  -> ``linrec2`` (2x2 companion Hillis) and, for
  long signals, ``linrec2_file_fir`` (chunked Toeplitz matmul);
- per-sample 2x2 (the wah's swept filter)  -> ``mat2_affine_hillis``;
- the dynamics family's semiring scans: peak decay  y[n] = max(b[n],
  a[n]*y[n-1])  -> ``maxtimes_hillis`` / ``maxtimes_scan_long``; capped
  release  y[n] = min(c[n], a[n]*y[n-1] + b[n])  -> ``minaffine_hillis``;
  trailing-window min and sum -> ``window_min_trailing`` /
  ``window_sum_trailing``.

PyTorch has no public associative scan, so every scan here is a
Hillis-Steele over the last axis: log2(N) levels of pad + slice + FMA.
Same math as the reference up to reassociation.  All float32 except the
biquad, which ``biquad_block`` solves in float64 (see there); the
Toeplitz products go through ``_matmul``, which refuses TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aefs_tpu_torch import check_precision
from aefs_tpu_torch.core.params import lead


def _matmul(a, b):
    check_precision()
    return torch.matmul(a, b)


def _f32(v, like):
    """``v`` as a float32 tensor on ``like``'s device (tensors pass through).
    A number is filled on the device, never uploaded: the streaming step
    is captured as a CUDA graph (core/packing.py)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _shift(t, s: int, fill=0.0):
    """t[..., n - s] along the last axis, ``fill`` where n < s."""
    n = t.shape[-1]
    return F.pad(t, (s, 0), value=fill)[..., :n]


def affine_hillis(mult, add, init):
    """Solve y[n] = mult[n]*y[n-1] + add[n] over the LAST axis, y[-1] = init.

    mult: broadcastable to ``add`` (..., N); init: broadcastable to one
    last-axis slice.  Returns y (..., N)."""
    n = add.shape[-1]
    a = torch.broadcast_to(_f32(mult, add), add.shape)
    b = add
    s = 1
    while s < n:
        a_sh = _shift(a, s, 1.0)
        b_sh = _shift(b, s)
        b = a * b_sh + b
        a = a * a_sh
        s *= 2
    return a * _f32(init, add) + b


def affine_scan(mult, add, init, axis: int = 0):
    """``affine_hillis`` along ``axis``; ``mult`` a scalar or shaped like
    ``add``."""
    add_l = add.movedim(axis, -1)
    mult = _f32(mult, add)
    mult_l = mult if mult.ndim == 0 else mult.movedim(axis, -1)
    init = _f32(init, add)
    if init.ndim:
        init = init.unsqueeze(-1)
    return affine_hillis(mult_l, add_l, init).movedim(-1, axis)


def affine_scan_long(mult, add, init, chunk: int = 512):
    """``affine_hillis`` for long signals, two-level blocked: an in-chunk
    scan over (N/chunk, chunk) rows, then a small cross-row scan over the
    row summaries.  mult: broadcastable to ``add`` (..., N); init:
    broadcastable to (..., 1).  Leading axes are independent streams (the
    files of a batched render), each scanned with the same operations."""
    n = add.shape[-1]
    c = int(chunk)
    if n <= c:
        return affine_hillis(mult, add, init)
    lead_shape = add.shape[:-1]
    m = -(-n // c)
    a_c = F.pad(torch.broadcast_to(_f32(mult, add), add.shape), (0, m * c - n),
                value=1.0).reshape(*lead_shape, m, c)
    b_c = F.pad(add, (0, m * c - n)).reshape(*lead_shape, m, c)
    s = 1
    while s < c:
        a_sh = _shift(a_c, s, 1.0)
        b_sh = _shift(b_c, s)
        b_c = a_c * b_sh + b_c
        a_c = a_c * a_sh
        s *= 2
    init = _f32(init, add)
    s_out = affine_hillis(a_c[..., -1], b_c[..., -1], init)  # value leaving each row
    s_in = torch.cat([torch.broadcast_to(init, lead_shape + (1,)), s_out[..., :-1]], -1)
    y = a_c * s_in[..., None] + b_c
    return y.reshape(*lead_shape, m * c)[..., :n]


def maxtimes_hillis(mult, add, init):
    """Solve y[n] = max(add[n], mult[n]*y[n-1]) over the LAST axis,
    y[-1] = init: the (max, x) semiring analogue of ``affine_hillis`` (the
    compressor's peak decay).  The maps y -> max(b, a*y) with a >= 0
    compose as (a1*a2, max(b2, a2*b1)); identity (1, 0) because every
    operand is nonnegative.

    mult, add: (..., N) nonnegative (``mult`` broadcast first); init:
    nonnegative, broadcastable to one last-axis slice."""
    n = add.shape[-1]
    a = torch.broadcast_to(_f32(mult, add), add.shape)
    b = add
    s = 1
    while s < n:
        a_sh = _shift(a, s, 1.0)
        b_sh = _shift(b, s)  # fill 0 = max identity
        b = torch.maximum(a * b_sh, b)
        a = a * a_sh
        s *= 2
    return torch.maximum(a * _f32(init, add), b)


def maxtimes_scan_long(mult, add, init, chunk: int = 512):
    """``maxtimes_hillis`` for long signals, two-level blocked like
    ``affine_scan_long``.  mult, add: (..., N) nonnegative (``mult``
    broadcast first); init: nonnegative, broadcastable to (..., 1)."""
    n = add.shape[-1]
    c = int(chunk)
    if n <= c:
        return maxtimes_hillis(mult, add, init)
    lead_shape = add.shape[:-1]
    m = -(-n // c)
    a_c = F.pad(torch.broadcast_to(_f32(mult, add), add.shape), (0, m * c - n),
                value=1.0).reshape(*lead_shape, m, c)
    b_c = F.pad(add, (0, m * c - n)).reshape(*lead_shape, m, c)
    s = 1
    while s < c:
        a_sh = _shift(a_c, s, 1.0)
        b_sh = _shift(b_c, s)
        b_c = torch.maximum(a_c * b_sh, b_c)
        a_c = a_c * a_sh
        s *= 2
    init = _f32(init, add)
    s_out = maxtimes_hillis(a_c[..., -1], b_c[..., -1], init)  # value leaving each row
    s_in = torch.cat([torch.broadcast_to(init, lead_shape + (1,)), s_out[..., :-1]], -1)
    y = torch.maximum(a_c * s_in[..., None], b_c)
    return y.reshape(*lead_shape, m * c)[..., :n]


def minaffine_hillis(mult, add, cap, init):
    """Solve y[n] = min(cap[n], mult[n]*y[n-1] + add[n]) over the LAST
    axis, y[-1] = init: the limiter's capped release.  The maps
    y -> min(c, a*y + b) with a >= 0 compose closed,
    (a2*a1, a2*b1 + b2, min(c2, a2*c1 + b2)), identity (1, 0, no cap).

    The identity's cap is the largest finite float32, not +inf as in the
    JAX package: over a whole file the span products a^k underflow to 0,
    and 0 * inf is NaN (JAX renders NaN there, e.g. "Master Bus" on the
    18.6 s demo).  With a finite cap, a2 = 0 gives min(c2, b2), which is
    exactly what the map y -> min(c2, 0*y + b2) is.  For a <= 1 the
    result is otherwise the same.

    mult, add, cap: (..., N), 0 <= a <= 1; init broadcastable to one
    last-axis slice.  Returns y (..., N)."""
    n = add.shape[-1]
    a = torch.broadcast_to(_f32(mult, add), add.shape)
    b = add
    c = torch.broadcast_to(_f32(cap, add), add.shape)
    no_cap = torch.finfo(torch.float32).max
    s = 1
    while s < n:
        a1 = _shift(a, s, 1.0)
        b1 = _shift(b, s)
        c1 = _shift(c, s, no_cap)
        a, b, c = a * a1, a * b1 + b, torch.minimum(c, a * c1 + b)
        s *= 2
    return torch.minimum(c, a * _f32(init, add) + b)


def window_min_trailing(ext, w: int, n: int):
    """min over the trailing ``w``-sample window, for the last ``n``
    positions of ``ext`` (..., H + n) with H >= w - 1 history: power-of-two
    window mins by pairwise min with a static shift, then one overlapping
    combine for any w (valid for idempotent min)."""
    m = ext
    k = 1
    while 2 * k <= w:
        m = torch.minimum(m[..., k:], m[..., :-k])  # window 2k mins
        k *= 2
    if w > k:  # two k-windows covering w
        m = torch.minimum(m[..., w - k:], m[..., : m.shape[-1] - (w - k)])
    return m[..., -n:]


def window_sum_trailing(ext, w: int, n: int):
    """Sum over the trailing ``w``-sample window for the last ``n``
    positions of ``ext``: w decomposed in binary into DISJOINT power-of-two
    chunk sums.  Not a cumsum: every partial is a local sum of <= w terms,
    where a running total loses ~ulp(N) per sample at file lengths."""
    sums = {1: ext}
    k = 1
    while 2 * k <= w:
        s = sums[k]
        sums[2 * k] = s[..., k:] + s[..., :-k]
        k *= 2
    total = None
    off = 0  # distance already consumed at the window's trailing end
    k = 1
    while k <= w:
        if w & k:
            s = sums[k]
            sl = s[..., s.shape[-1] - n - off: s.shape[-1] - off]
            total = sl if total is None else total + sl
            off += k
        k *= 2
    return total


def const_affine_hillis(h, add, init):
    """Solve y[n] = h*y[n-1] + add[n] over the LAST axis for a constant
    coefficient ``h`` (scalar, or (..., 1) against (..., N)), with h^s
    tracked by repeated squaring; y[-1] = init."""
    n = add.shape[-1]
    h = _f32(h, add)
    assert not h.ndim or h.shape[-1] == 1, h.shape
    b = add
    hp = h
    s = 1
    while s < n:
        b = b + hp * _shift(b, s)
        hp = hp * hp
        s *= 2
    # Carried-in value: y[n] += init * h^(n+1).
    hpow = h * torch.pow(h, torch.arange(n, dtype=torch.float32, device=add.device))
    return b + _f32(init, add) * hpow


def toeplitz_lower(h, c: int):
    """Lower-triangular Toeplitz T[j, i] = h[j - i] (j >= i, else 0)."""
    idx = (torch.arange(c, device=h.device)[:, None]
           - torch.arange(c, device=h.device)[None, :])
    return torch.where(idx >= 0, h[idx.clamp(min=0)], torch.zeros((), dtype=h.dtype,
                                                                  device=h.device))


def lag_affine_scan(base, a, lag: int, row_chunk: int = 128):
    """Solve y[n] = base[n] + a*y[n-lag] for n >= lag, y[n] = base[n] else.

    ``lag`` static, ``a`` a scalar.  Samples fall into ``lag`` residue
    classes; reshaping to (M, lag) rows makes it a first-order scan over
    rows, solved per chunk of C rows as one lower-triangular Toeplitz
    matmul T[j, i] = a^(j-i) plus an a^C-coefficient carry scan over the
    chunk summaries.  base: (..., N), leading axes independent signals (the
    files of a batched render).  Returns y: (..., N)."""
    n = base.shape[-1]
    lead_shape = base.shape[:-1]
    m = -(-n // lag)
    a = _f32(a, base)
    padded = F.pad(base, (0, m * lag - n)).reshape(*lead_shape, m, lag)
    zeros = torch.zeros((lag,), device=base.device)

    if m <= 8:
        y = affine_scan(a, padded, zeros, axis=-2)
        return y.reshape(*lead_shape, m * lag)[..., :n]

    c = min(int(row_chunk), -(-m // 8) * 8)
    mp = -(-m // c)
    chunks = F.pad(padded, (0, 0, 0, mp * c - m)).reshape(*lead_shape, mp, c, lag)
    h = torch.pow(a, torch.arange(c + 1, dtype=torch.float32, device=base.device))
    y_loc = _matmul(toeplitz_lower(h, c), chunks)  # (..., mp, c, lag)
    # Cross-chunk carries: s_k = a^C * s_{k-1} + y_loc[k, -1, :], s_{-1} = 0.
    s = affine_scan(h[c], y_loc[..., -1, :], zeros, axis=-2)
    s_in = torch.cat([torch.zeros(lead_shape + (1, lag), device=base.device),
                      s[..., :-1, :]], -2)
    y = y_loc + h[1 : c + 1][:, None] * s_in[..., None, :]
    return y.reshape(*lead_shape, mp * c * lag)[..., : m * lag][..., :n]


def _signed_pow(p, k):
    """p**k for real p and integer-valued k >= 0, branch-free."""
    mag = torch.exp(k * torch.log(torch.clamp(torch.abs(p), min=1e-30)))
    mag = torch.where(k == 0, torch.ones_like(mag), mag)
    odd = torch.remainder(k.to(torch.int32), 2).to(mag.dtype)
    return mag * torch.where(p < 0, 1.0 - 2.0 * odd, torch.ones_like(odd))


def ar2_impulse(a1, a2, length: int):
    """h[0..length-1] of h[n] = -a1 h[n-1] - a2 h[n-2] (h[0] = 1) in
    CLOSED FORM over the pole structure — never log-doubling, which
    squares near-cancelling companion entries and yields NaN at legal
    near-unit pole radii (the reference's ar2_impulse docstring).  In the
    dtype of ``a1`` (a tensor); the biquad calls it in float64."""
    a2 = a2.to(a1.dtype)
    if length == 1:
        return torch.ones((1,), dtype=a1.dtype, device=a1.device)
    n = torch.arange(length, dtype=a1.dtype, device=a1.device)
    m = -0.5 * a1  # mean pole
    disc = m * m - a2
    scale = m * m + torch.abs(a2) + 1e-30
    is_crit = torch.abs(disc) <= 1e-6 * scale
    is_cplx = disc < 0

    # Complex pair r e^{+-it}.
    q_ = torch.sqrt(torch.clamp(-disc, min=1e-30))
    r = torch.sqrt(torch.clamp(a2, min=1e-30))
    t = torch.atan2(q_, m)
    r_n = torch.exp(n * torch.log(torch.clamp(r, min=1e-30)))
    h_cplx = r_n * torch.sin((n + 1.0) * t) / torch.clamp(torch.sin(t), min=1e-30)

    # Distinct real poles.
    s = torch.sqrt(torch.clamp(disc, min=1e-30))
    h_real = (_signed_pow(m + s, n + 1.0) - _signed_pow(m - s, n + 1.0)) / (2.0 * s)

    # Repeated pole.
    h_crit = (n + 1.0) * _signed_pow(m, n)

    h = torch.where(is_crit, h_crit, torch.where(is_cplx, h_cplx, h_real))
    return torch.cat([torch.ones((1,), dtype=h.dtype, device=h.device), h[1:]])


def _mat2_hillis(cp, cq, cr, cs, cu, cv):
    """Inclusive prefix composition over the last axis of the 2x2 affine
    maps s -> [[p, q], [r, s]] @ s + [u, v] (earlier maps applied first),
    identity fill past the left edge."""
    n = cu.shape[-1]
    k = 1
    while k < n:
        p1 = _shift(cp, k, 1.0)
        q1 = _shift(cq, k)
        r1 = _shift(cr, k)
        s1 = _shift(cs, k, 1.0)
        u1 = _shift(cu, k)
        v1 = _shift(cv, k)
        cp, cq, cr, cs, cu, cv = (
            cp * p1 + cq * r1,
            cp * q1 + cq * s1,
            cr * p1 + cs * r1,
            cr * q1 + cs * s1,
            cp * u1 + cq * v1 + cu,
            cr * u1 + cs * v1 + cv,
        )
        k *= 2
    return cp, cq, cr, cs, cu, cv


def mat2_affine_hillis(mp, mq, mr, ms, bu, bv, init1, init2):
    """Solve s[n] = M[n] @ s[n-1] + b[n] over the last axis with per-sample
    matrices M[n] = [[mp, mq], [mr, ms]][n], b[n] = [bu, bv][n] and
    s[-1] = [init1, init2]: the time-varying form of ``linrec2`` (the
    wah's swept state-variable filter).  The coefficients broadcast to
    ``bu`` (..., N); init1/init2 to one last-axis slice.  Returns the two
    state components (s1, s2), each (..., N)."""
    shp = bu.shape
    cp, cq, cr, cs, cu, cv = _mat2_hillis(
        *(torch.broadcast_to(_f32(t, bu), shp) for t in (mp, mq, mr, ms)),
        bu, torch.broadcast_to(_f32(bv, bu), shp))
    i1, i2 = _f32(init1, bu), _f32(init2, bu)
    return cp * i1 + cq * i2 + cu, cr * i1 + cs * i2 + cv


def linrec2(v, a1, a2, y1, y2):
    """Solve y[n] = v[n] - a1*y[n-1] - a2*y[n-2] with y[-1]=y1, y[-2]=y2
    over the last axis.  v: (..., N); coefficients 0-dim or broadcastable
    to v; y1, y2: (...)."""
    shp = v.shape
    a1 = a1.to(v.dtype)
    a2 = a2.to(v.dtype)
    ones = torch.ones(shp, dtype=v.dtype, device=v.device)
    zeros = torch.zeros(shp, dtype=v.dtype, device=v.device)
    cp, cq, _, _, cu, _ = _mat2_hillis(
        torch.broadcast_to(-a1, shp), torch.broadcast_to(-a2, shp), ones, zeros, v, zeros)
    return cp * y1[..., None] + cq * y2[..., None] + cu


def linrec2_file_fir(x, b0, b1, b2, a1, a2, x1, x2, y1, y2, chunk: int = 256):
    """Whole biquad B(z)/A(z) over a long signal: per chunk of C samples
    the response is one Toeplitz matmul against conv(b, h) (h the AR
    impulse response) plus rank-1 terms for the previous chunk's x
    boundary; the (y[-1], y[-2]) carries cross chunks through a 2x2
    affine scan over the chunk summaries.

    x: (..., N); coefficients 0-dim tensors; x1, x2, y1, y2: (...), all in
    one dtype.  Returns y: (..., N)."""
    n = x.shape[-1]
    c = int(chunk)
    m = -(-n // c)
    lead = x.shape[:-1]
    xp = F.pad(x, (0, m * c - n)).reshape(*lead, m, c)

    h = ar2_impulse(a1, a2, c + 1)  # AR impulse h[0..c]
    z1 = torch.zeros((1,), dtype=x.dtype, device=x.device)
    h_ba = (b0 * h[:c]
            + b1 * torch.cat([z1, h[: c - 1]])
            + b2 * torch.cat([z1, z1, h[: c - 2]]))
    y_base = _matmul(xp, toeplitz_lower(h_ba, c).T)  # y[m, j] = sum_i x[m, i] T[j, i]

    # Previous-chunk x boundary samples (known, not part of the carry).
    xp1 = torch.cat([x1[..., None], xp[..., :-1, c - 1]], -1)
    xp2 = torch.cat([x2[..., None], xp[..., :-1, c - 2]], -1)
    hx1 = b1 * h[:c] + b2 * torch.cat([z1, h[: c - 1]])
    hx2 = b2 * h[:c]
    y_base = y_base + xp1[..., None] * hx1 + xp2[..., None] * hx2

    h1 = h[1 : c + 1]  # response to y[-1] = 1
    h2 = -a2 * h[:c]  # response to y[-2] = 1
    shp = y_base.shape[:-1]  # (..., m)
    cp, cq, cr, cs, cu, cv = _mat2_hillis(
        torch.broadcast_to(h1[c - 1], shp), torch.broadcast_to(h2[c - 1], shp),
        torch.broadcast_to(h1[c - 2], shp), torch.broadcast_to(h2[c - 2], shp),
        y_base[..., c - 1], y_base[..., c - 2],
    )
    y1c, y2c = y1[..., None], y2[..., None]
    out1 = cp * y1c + cq * y2c + cu  # y[-1] entering chunk k+1
    out2 = cr * y1c + cs * y2c + cv  # y[-2] entering chunk k+1
    in1 = torch.cat([y1c, out1[..., :-1]], -1)
    in2 = torch.cat([y2c, out2[..., :-1]], -1)
    y = y_base + in1[..., None] * h1 + in2[..., None] * h2
    return y.reshape(*lead, m * c)[..., :n]


# Signals of this many samples or more take the biquad's chunked Toeplitz
# solve; shorter ones (the streaming blocks) the companion scan, which the
# card runs as one kernel (ops/kernels/biquad.py).
BIQUAD_FILE_SOLVE = 1024


def biquad_block(x, b0, b1, b2, a1, a2, state):
    """Direct-Form-I biquad over a block, per channel.

    x: (..., C, N) float32; state: (..., C, 4) = [x1, x2, y1, y2] per
    channel; coefficients float32 (...) (constant within the block), one
    per leading index (the pool's slots) or 0-dim.  Returns (y, new_state),
    float32.  Blocks of 1,024 samples or more take the chunked Toeplitz
    solve, which takes 0-dim coefficients (a batched render's files share
    them; the signal keeps its leading axes).

    Solved in float64 from the float32 coefficients, input and state, and
    rounded once.  The JAX package solves in float32, and both its forms
    lose most of the parity margin at low cutoffs: near-unit poles make the
    companion scan's repeated squaring and the FIR fold's cancellation
    ill-conditioned.  At the 150 Hz high-pass of the "Multiband Master"
    crossover it stays only -40 dBFS (streaming) and -68 dBFS (file mode)
    from the float64 oracle on the demo; in float64 the port meets the
    oracle bar there too, and the CPU and the card do the same arithmetic."""
    out_dtype = x.dtype
    x, state = x.double(), state.double()
    b0, b1, b2, a1, a2 = (c.double() for c in (b0, b1, b2, a1, a2))
    n = x.shape[-1]
    x1, x2, y1, y2 = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    if n >= BIQUAD_FILE_SOLVE:
        # Long signals: chunked Toeplitz solve.  Streaming blocks keep the
        # scan (the matmul form loses ~12 dB under per-block coefficient
        # glides at high Q — the reference's biquad_block note).
        y = linrec2_file_fir(x, b0, b1, b2, a1, a2, x1, x2, y1, y2)
        xm1_last = x[..., -2]
    else:
        b0, b1, b2, a1, a2 = (lead(c, 2) for c in (b0, b1, b2, a1, a2))
        xm1 = torch.cat([x1[..., None], x[..., :-1]], -1)[..., :n]  # x[n-1]
        xm2 = torch.cat([x2[..., None], x1[..., None], x[..., :-2]], -1)[..., :n]  # x[n-2]
        v = b0 * x + b1 * xm1 + b2 * xm2
        y = linrec2(v, a1, a2, y1, y2)
        xm1_last = xm1[..., -1]
    ym2 = y[..., -2] if n >= 2 else y1
    return (y.to(out_dtype),
            torch.stack([x[..., -1], xm1_last, y[..., -1], ym2], -1).to(out_dtype))
