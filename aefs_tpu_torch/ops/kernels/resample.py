"""Kernels K1 (both octaver grain taps) and K3 (one stream's tap read,
rows in one launch), both in csrc/resample.cu, and their plain PyTorch
versions.

K1 replaces the TPU kernel ``aefs_tpu/ops/pallas/resample.py:_fused_kernel``,
K3 replaces ``resample.py:_resample_kernel``.  The TPU kernels evaluate the
4-tap Hermite read as a banded one-hot contraction to avoid TPU gathers; on
the GPU the read is a direct gather, one thread per output sample, with the
ring-wrap patch folded in.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.ops.kernels import check, library, require_cuda_f32, stream_ptr


def octaver_taps_plain(hist, x, ago1, ago2):
    """Plain version: the gather read of ``ringbuf.fractional_read_cubic``
    (bulk Hermite + wrap patch) on each ``ago`` stream."""
    from aefs_tpu_torch.ops.ringbuf import fractional_read_cubic

    return fractional_read_cubic(hist, x, ago1), fractional_read_cubic(hist, x, ago2)


def octaver_taps(hist, x, ago1, ago2):
    """Both octaver taps: hist (S,), x (N,), ago1/ago2 (N,) float32 distances
    into the past of hist ++ x -> (s1, s2), each (N,).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``octaver_taps.launches``) or raise."""
    if hist.device.type == "cpu":
        return octaver_taps_plain(hist, x, ago1, ago2)
    s, n = hist.shape[-1], x.shape[-1]
    require_cuda_f32("hist", hist, (s,))
    require_cuda_f32("x", x, (n,))
    require_cuda_f32("ago1", ago1, (n,))
    require_cuda_f32("ago2", ago2, (n,))
    if s < 4 or n < 1:
        raise ValueError(f"octaver_taps needs a ring of >= 4 and a block >= 1, got {s}, {n}")
    if len({t.device for t in (hist, x, ago1, ago2)}) != 1:
        raise ValueError("octaver_taps operands must share one device")
    s1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    s2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = library().aefs_octaver_taps(
        hist.data_ptr(), x.data_ptr(), ago1.data_ptr(), ago2.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), s, n, stream_ptr(x.device))
    check(err, "octaver_taps")
    octaver_taps.launches += 1
    return s1, s2


octaver_taps.launches = 0


def fractional_read_plain(hist, x, ago):
    """Plain version of K3: ``ringbuf.fractional_read_cubic`` on each row."""
    from aefs_tpu_torch.ops.ringbuf import fractional_read_cubic

    return torch.stack([fractional_read_cubic(h, xr, a) for h, xr, a in zip(hist, x, ago)])


def fractional_read(hist, x, ago):
    """One stream's tap read per row: hist (R, S), x (R, N), ago (R, N)
    float32 distances into the past of hist[r] ++ x[r] -> (R, N).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``fractional_read.launches``) or raise."""
    if hist.device.type == "cpu":
        return fractional_read_plain(hist, x, ago)
    if hist.ndim != 2:
        raise ValueError(f"fractional_read takes hist (R, S), got shape {tuple(hist.shape)}")
    r, s = hist.shape
    n = x.shape[-1]
    require_cuda_f32("hist", hist)
    require_cuda_f32("x", x, (r, n))
    require_cuda_f32("ago", ago, (r, n))
    if s < 4 or n < 1 or r < 1:
        raise ValueError(f"fractional_read needs rows >= 1, a history >= 4 and a block >= 1, "
                         f"got {r}, {s}, {n}")
    if len({t.device for t in (hist, x, ago)}) != 1:
        raise ValueError("fractional_read operands must share one device")
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    err = library().aefs_fractional_read(
        hist.data_ptr(), x.data_ptr(), ago.data_ptr(), out.data_ptr(), r, s, n,
        stream_ptr(x.device))
    check(err, "fractional_read")
    fractional_read.launches += 1
    return out


fractional_read.launches = 0
