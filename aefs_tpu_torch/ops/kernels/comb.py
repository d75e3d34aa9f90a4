"""Kernels K2 (whole-file reverb comb sums) and K4 (the same comb bank
with every chunk's y and damped), both in csrc/comb.cu, and their plain
PyTorch versions.

K2 replaces the TPU kernel ``aefs_tpu/ops/pallas/comb.py:_make_sums_kernel``
(contract of ``comb_bank_file_pallas_sums``), K4 replaces ``comb.py:_make_kernel``
(contract of ``comb_bank_file_pallas``).  The TPU kernels carry the chunk
recursion across sequential grid steps; the CUDA kernel runs the chunk loop
inside one thread block per comb, each thread holding a few consecutive
lanes of a chunk (the launcher picks how many from C); K2 then sums each
side's combs in a second kernel.  Both take a leading file axis, x
(F, S, N) with g and h shared: the grid is (combs, files), one launch for
a batched render's F files, each file's block doing the arithmetic of an
F = 1 launch.  The plain versions share one loop, the
reference's exact-recursion fallback (``ringbuf.comb_bank_file_chunks``'
XLA path): a full-fp32 (C, C) damping propagator per chunk.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from aefs_tpu_torch.ops.kernels import check, library, require_cuda_f32, stream_ptr, tick

# Tap budget for the static-h truncated-FIR damping: taps = J+1 with
# J = ceil(-40/log2 h), so the cutoff is h <= 2^(-40/31) ~= 0.409; larger
# h keeps the scan.  Also the length of the kernel's by-value weight array.
_FIR_TAP_BUDGET = 32
MAX_COMBS = 16  # AEFS_MAX_COMBS in csrc/comb.cu: per file
MAX_FILES = 65535  # the grid's y dimension


def fir_damp_weights(h_static: float, budget: int = _FIR_TAP_BUDGET):
    """Truncated-FIR damping weights for a STATIC damping coefficient:
    damped[n] = sum_t w_t y[n-t] with w_t = (1-h) h^t, truncated at the
    first J with h^(J+1) <= 2^-40 — the dropped tail is two decades below
    the f32 ulp of the result, so the FIR is exact relative to the
    recursion in f32.  None when h needs more than ``budget`` taps."""
    h = float(np.float32(h_static))
    if not (0.0 <= h < 1.0):
        return None
    if h == 0.0:
        return (np.float32(1.0),)
    j = int(math.ceil(-40.0 / math.log2(h)))
    if j + 1 > budget:
        return None
    return tuple(np.float32((1.0 - h) * h**t) for t in range(j + 1))


def fir_kernel_weights(h_static):
    """The damping argument the kernel takes by value: (w, n_taps), w a
    float32 array of ``_FIR_TAP_BUDGET`` holding ``fir_damp_weights(h_static)``
    zero-padded.  n_taps == 0 (w all zeros) selects the scan: h_static None,
    outside [0, 1), or needing more taps than the budget."""
    w = np.zeros(_FIR_TAP_BUDGET, np.float32)
    fir = None if h_static is None else fir_damp_weights(h_static)
    if fir is None:
        return w, 0
    w[:len(fir)] = fir
    return w, len(fir)


def _per_file(plain, x, *args):
    """``plain`` on each file of x (F, S, N), outputs stacked on a leading
    F: every file runs the F = 1 operations."""
    outs = [plain(xf, *args) for xf in x]
    return tuple(torch.stack(o) for o in zip(*outs))


def comb_chunks_plain(x, g, h, lags, c, side_of):
    """Plain version of K4: the exact chunk recursion with a (C, C)
    propagator T_h[j, i] = h^(j-i) per chunk.  Same contract as
    ``comb_chunks``."""
    from aefs_tpu_torch.ops.scan import _matmul

    if x.dim() == 3:
        return _per_file(comb_chunks_plain, x, g, h, lags, c, side_of)

    dev = x.device
    _, n = x.shape
    b = len(lags)
    m = -(-n // c)
    n_pad = m * c
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    g = torch.as_tensor(g, dtype=torch.float32, device=dev)
    # Per-comb lag-shifted input chunks (M, B, C).
    xs = torch.stack(
        [F.pad(x[side_of[i]], (lag, n_pad - n))[:n_pad].reshape(m, c)
         for i, lag in enumerate(lags)], 1)
    j_i = torch.arange(c, device=dev)[:, None] - torch.arange(c, device=dev)[None, :]
    t_h = torch.where(j_i >= 0, torch.pow(h, j_i.clamp(min=0).to(torch.float32)),
                      torch.zeros((), device=dev))
    t_h_t = t_h.T.contiguous()
    hpow = torch.pow(h, torch.arange(1, c + 1, dtype=torch.float32, device=dev))
    # damped[n - L] of chunk k sits at lane 2C - L + j of [chunk k-2 | k-1].
    lag_t = torch.tensor(list(lags), device=dev)
    read = (2 * c - lag_t)[:, None] + torch.arange(c, device=dev)
    g_col = g[:, None]
    one_mh = 1.0 - h
    prev = torch.zeros((b, 2 * c), device=dev)
    d_last = torch.zeros((b,), device=dev)
    ys, damps = [], []
    for k in range(m):
        y = xs[k] + g_col * torch.gather(prev, 1, read)
        damped = _matmul(one_mh * y, t_h_t) + d_last[:, None] * hpow
        prev = torch.cat([prev[:, c:], damped], 1)
        d_last = damped[:, -1]
        ys.append(y)
        damps.append(damped)
    return torch.stack(ys), torch.stack(damps)


def comb_sums_plain(x, g, h, lags, c, side_of, n_sides):
    """Plain version of K2: ``comb_chunks_plain`` reduced to the per-side
    sums and the last three damped chunks.  Same contract as ``comb_sums``."""
    if x.dim() == 3:
        return _per_file(comb_sums_plain, x, g, h, lags, c, side_of, n_sides)
    dev = x.device
    b = len(lags)
    y_mbc, d_mbc = comb_chunks_plain(x, g, h, lags, c, side_of)
    m = y_mbc.shape[0]
    ysum = torch.stack([
        sum((y_mbc[:, bi] for bi in range(b) if side_of[bi] == si),
            torch.zeros((m, c), device=dev))
        for si in range(n_sides)
    ])
    k = min(m, 3)
    d_tail = torch.cat([torch.zeros((3 - k, b, c), device=dev), d_mbc[m - k:]])
    return ysum, d_tail


def _check_operands(name, x, g, h, lags, c, side_of):
    """Validate what the comb kernels take (CUDA f32 operands on one
    device, x (S, N) or (F, S, N) with 1 <= F <= 65,535 (the grid's file
    dimension), side_of mapping every comb onto a row of x, C <= L < 2C).
    Returns the file count, 0 without a file axis."""
    b = len(lags)
    require_cuda_f32("x", x)
    require_cuda_f32("g", g, (b,))
    require_cuda_f32("h", h, ())
    if x.ndim not in (2, 3) or 0 in x.shape[:-1]:
        raise ValueError(f"{name}: x must be (S, N) or (F, S, N), got {tuple(x.shape)}")
    files = x.shape[0] if x.ndim == 3 else 0
    if files > MAX_FILES:
        raise ValueError(f"{name}: {files} files (the kernel takes 1 to {MAX_FILES})")
    s_rows = x.shape[-2]
    if len({x.device, g.device, h.device}) != 1:
        raise ValueError(f"{name} operands must share one device")
    if not 1 <= b <= MAX_COMBS:
        raise ValueError(f"{name}: {b} combs (the kernel takes 1 to {MAX_COMBS})")
    if len(side_of) != b or not all(0 <= s < s_rows for s in side_of):
        raise ValueError(f"side_of {side_of} does not map {b} combs onto {s_rows} rows")
    if not all(c <= lag < 2 * c for lag in lags):
        raise ValueError(f"comb lags {lags} violate C <= L < 2C for C={c}")
    return files


def comb_sums(x, g, h, lags, c, side_of, n_sides, h_static=None):
    """Whole-file comb bank sums.

    x: (S, N) float32 raw source signals (no padding needed), or
    (F, S, N) for F files sharing g and h; g: (B,) gains; h: 0-dim damping;
    lags, side_of: static int tuples (B,), every lag in [C, 2C); c: chunk
    size; n_sides: number of output sums; h_static: baked damping — when
    ``fir_damp_weights`` accepts it the kernel damps with the exact
    truncated FIR, else it scans with ``h``.

    Returns (ysum (n_sides, M, C), d_tail (3, B, C)), M = ceil(N / C), each
    with a leading F when x has one (one launch for all files).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``comb_sums.launches``) or raise, also for a chunk whose
    block the card cannot hold (C > 14,336 on the H100)."""
    lags = tuple(int(l) for l in lags)
    side_of = tuple(int(s) for s in side_of)
    if x.device.type == "cpu":
        return comb_sums_plain(x, g, h, lags, c, side_of, n_sides)
    files = _check_operands("comb_sums", x, g, h, lags, c, side_of)
    lead = x.shape[:-2]
    s_rows, n = x.shape[-2:]
    b = len(lags)
    m = -(-n // c)
    w, n_taps = fir_kernel_weights(h_static)
    y = torch.empty(lead + (m, b, c), dtype=torch.float32, device=x.device)
    ysum = torch.empty(lead + (n_sides, m, c), dtype=torch.float32, device=x.device)
    d_tail = torch.empty(lead + (3, b, c), dtype=torch.float32, device=x.device)
    lags_c = (ctypes.c_int * b)(*lags)
    side_c = (ctypes.c_int * b)(*side_of)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_comb_sums(
            x.data_ptr(), s_rows, n, max(files, 1), g.data_ptr(), h.data_ptr(), w.ctypes.data,
            n_taps,
            ctypes.addressof(lags_c), ctypes.addressof(side_c), b, c, m, n_sides,
            y.data_ptr(), ysum.data_ptr(), d_tail.data_ptr(), x.get_device(),
            stream_ptr(x.device))
    check(err, "comb_sums")
    tick(comb_sums)
    return ysum, d_tail


comb_sums.launches = 0


def comb_chunks(x, g, h, lags, c, side_of):
    """Whole-file comb bank with every comb's output and damping state.

    x: (S, N) float32 raw source signals, or (F, S, N) for F files sharing
    g and h; g: (B,) gains; h: 0-dim traced damping; lags, side_of: static
    int tuples (B,), every lag in [C, 2C); c: chunk size.

    Returns (y, damped), each (M, B, C), M = ceil(N / C), with a leading F
    when x has one.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``comb_chunks.launches``) or raise, as for ``comb_sums``."""
    lags = tuple(int(l) for l in lags)
    side_of = tuple(int(s) for s in side_of)
    if x.device.type == "cpu":
        return comb_chunks_plain(x, g, h, lags, c, side_of)
    files = _check_operands("comb_chunks", x, g, h, lags, c, side_of)
    lead = x.shape[:-2]
    s_rows, n = x.shape[-2:]
    b = len(lags)
    m = -(-n // c)
    y = torch.empty(lead + (m, b, c), dtype=torch.float32, device=x.device)
    damped = torch.empty(lead + (m, b, c), dtype=torch.float32, device=x.device)
    lags_c = (ctypes.c_int * b)(*lags)
    side_c = (ctypes.c_int * b)(*side_of)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_comb_chunks(
            x.data_ptr(), s_rows, n, max(files, 1), g.data_ptr(), h.data_ptr(),
            ctypes.addressof(lags_c), ctypes.addressof(side_c), b, c, m,
            y.data_ptr(), damped.data_ptr(), x.get_device(), stream_ptr(x.device))
    check(err, "comb_chunks")
    tick(comb_chunks)
    return y, damped


comb_chunks.launches = 0
