"""Closed-form octaver taps for exact power-of-two pitch ratios (port of
aefs_tpu/ops/gridtaps.py).

At whole-octave settings (semitones = 12*e, the flagship's -12) the pitch
ratio r = 2^e is an exact binary float and, from fresh phase (file mode),
every tap position is an exact rational on a fixed grid:

    ago[n] = mod(n * (1 - r), S),    q[n] = S + n - ago[n]

For r = 1/D the output lanes split into D classes by n mod D, each reading
at a constant fractional offset c/D, so the Hermite read collapses into D
static 4-tap FIRs of the stream.  For r = R positions are integers at
stride R.  Integer arithmetic end to end: no float32 phase floor, parity
with the float64 oracle at -80 dBFS.  Ring-wrap lanes keep the reference
semantics via ``_wrap_patch``.

Each lane's position comes from an exact integer phase numerator and is
read with one gather per tap (``_pow2_taps``): from num = 0 over a whole
file (``octaver_taps_pow2``), and carried from block to block in
streaming (``octaver_taps_pow2_stream``).  Leading axes are independent
streams (a pool's slots, a batched render's files).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pow2_exponent(semitones):
    """e such that 2^(semitones/12) == 2^e exactly, else None."""
    if semitones is None:
        return None
    s = float(semitones)
    if not (-24.0 <= s <= 24.0) or s != round(s) or int(round(s)) % 12:
        return None
    return int(round(s)) // 12


def pow2_geometry_ok(size: int, e: int) -> bool:
    """Divisibility conditions for the exact grid decomposition."""
    s = int(size)
    if s % 2:
        return False
    if e == 0:
        return True
    if e < 0:
        d = 1 << (-e)
        if s % (d - 1):
            return False
        m = s // (d - 1)
        return m % 2 == 0
    r = 1 << e
    if s % (r - 1) or s % r or (s // 2) % r:
        return False
    mp = s // (r - 1)
    return mp % (2 * r) == 0


def pow2_stream_geometry_ok(size: int, e: int, blocksize: int) -> bool:
    """Divisibility/size conditions for the streaming exact-grid path
    (``octaver_taps_pow2_stream``, the octaver's ``grid_semitones``)."""
    s, n = int(size), int(blocksize)
    if s % 2 or n > s:
        return False
    if e < 0:
        d = 1 << (-e)
        return n % d == 0 and n // d <= s // (d - 1)
    r = 1 << e
    if s % r:
        return False
    return r == 1 or n * (r - 1) <= s


def _hermite_fir_weights(frac: float):
    """Static 4-tap weights: H(frac; y0..y3) of cubic_hermite collapsed per
    basis vector, in float64."""
    ws = []
    for k in range(4):
        y = [0.0] * 4
        y[k] = 1.0
        y0, y1, y2, y3 = y
        c0 = y1
        c1 = 0.5 * (y2 - y0)
        c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
        c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
        ws.append(((c3 * frac + c2) * frac + c1) * frac + c0)
    return ws


@functools.lru_cache(maxsize=None)
def _class_weights(d: int, device: torch.device):
    """(d, 4) float32 Hermite FIR weights of the classes c/d on ``device``:
    built once, so a streaming step makes no host-to-device copy (which
    would synchronize the host with the card every block)."""
    return torch.tensor([[float(np.float32(v)) for v in _hermite_fir_weights(c / d)]
                         for c in range(d)], dtype=torch.float32, device=device)


def _pow2_taps(hist, x, e: int, num):
    """Both octaver taps for ratio 2^e from the integer phase numerator
    ``num`` (see ``octaver_taps_pow2_stream``), one gather per tap.
    hist: (..., S); x: (..., N); num: integer (...).  Returns (s1, s2, p1,
    p2, new_num) with new_num int32."""
    from aefs_tpu_torch.ops.ringbuf import _take_last, _wrap_patch

    s = hist.shape[-1]
    n = x.shape[-1]
    dev = x.device
    f32 = torch.float32
    num = num.to(torch.int64)[..., None]
    i = torch.arange(n, dtype=torch.int64, device=dev)
    ext = torch.cat([hist, x], -1)
    # Quotients by device tensors: CUDA turns a division by a host scalar
    # into a reciprocal multiply, one ulp off the CPU.
    if e < 0:
        d = 1 << (-e)
        den = d * s
        # F_c[j] = H(c/d; ext[j-1], ext[j], ext[j+1], ext[j+2]), zero-padded.
        ext_p = F.pad(ext, (1, 3))
        w = _class_weights(d, dev)
        d_t = torch.full((), float(d), device=dev)

        def tap(r0):
            r = torch.remainder(r0 + i * (d - 1), den)
            ca = torch.div(r + d - 1, d, rounding_mode="floor")
            cls = ca * d - r
            pos = s + i - ca
            ys = [_take_last(ext_p, pos + k) for k in range(4)]
            wc = w[cls]  # class 0's weights are (0, 1, 0, 0): the sample itself
            vals = wc[..., 0] * ys[0] + wc[..., 1] * ys[1] + wc[..., 2] * ys[2] + wc[..., 3] * ys[3]
            frac = cls.to(f32) / d_t
            return _wrap_patch(ext, s, n, ca.to(torch.int32), frac, vals), r

        new_num = torch.remainder(num[..., 0] + n * (d - 1), den)
    else:
        r_up = 1 << e
        den = s

        def tap(r0):
            r = torch.remainder(r0 - i * (r_up - 1), s)
            vals = _take_last(ext, s + i - r)
            return _wrap_patch(ext, s, n, r.to(torch.int32), torch.zeros((), device=dev),
                               vals), r

        new_num = torch.remainder(num[..., 0] - n * (r_up - 1), s)
    s1, r1 = tap(num)
    s2, r2 = tap(torch.remainder(num + den // 2, den))
    den_t = torch.full((), float(den), device=dev)
    return s1, s2, r1.to(f32) / den_t, r2.to(f32) / den_t, new_num.to(torch.int32)


def octaver_taps_pow2_stream(hist, x, e: int, num):
    """Both octaver taps for ratio 2^e from an arbitrary carried phase,
    exactly: the streaming extension of ``octaver_taps_pow2``.

    The phase is carried as an integer numerator ``num``:

        e <  0 (ratio 1/D):  phase = num / (D*S),  num in [0, D*S)
        e >= 0 (ratio R):    phase = num / S,      num in [0, S)

    advanced per sample by +(D-1) mod D*S (down) or -(R-1) mod S (up), an
    exact integer recurrence with a closed-form block advance, so no float32
    phase accumulates (reference semantics: octaver.py:17-82).

    Each lane's read position is an integer computed from ``num`` in int64:
    pitch down, lane n reads the static 4-tap Hermite FIR of its class
    c = (n - num) mod D (fraction c/D, ``_class_weights``) at S + n - ca;
    pitch up, the plain sample at S + n - r.  One gather per tap.  (The JAX
    package evaluates the same reads as per-class contiguous slices, a TPU
    layout choice; the values are the same.)

    hist: (..., S) chronological ring history; x: (..., N) current block;
    num: integer (...), the leading axes being independent streams.
    Returns (s1, s2, p1, p2, new_num) with new_num int32."""
    s = hist.shape[-1]
    n = x.shape[-1]
    if not pow2_stream_geometry_ok(s, e, n):
        raise ValueError(f"no streaming exact grid for ring {s}, exponent {e}, block {n}")
    return _pow2_taps(hist, x, e, num)


def octaver_taps_pow2(hist, x, e: int):
    """Both octaver taps + exact phasor streams for ratio 2^e from fresh
    phase, over a whole signal: the stream taps' gathers from num = 0 (the
    JAX package's per-class FIR slices read the same values).
    hist: (..., S) chronological ring history; x: (..., N) signal, the
    leading axes being independent files.  Returns (s1, s2, p1, p2): taps
    (ring-wrap lanes patched to reference semantics) and the exact phasors
    in [0, 1)."""
    assert pow2_geometry_ok(hist.shape[-1], e), (hist.shape[-1], e)
    num = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    return _pow2_taps(hist, x, e, num)[:4]
