"""Kernel K6 (the flanger's line solve), in csrc/flanger.cu, and its plain
PyTorch version.  ``models/flanger.py`` solves every block through it: a
whole file, a streaming step of one slot or of many.

K6 replaces no TPU kernel: the JAX package solves a block with XLA matmuls
(``aefs_tpu/models/flanger.py``, no ``pallas_call``), one dense one-hot tap
operator a 256-sample chunk, iterated or squared.  That form in eager
PyTorch was ~129,000 launches for an 18.6 s stereo file.  The kernel runs
the recurrence underneath directly, for every row (file, slot and
channel) in one launch:

    tap[n] = ((w0 v[p] + w1 v[p+1]) + w2 v[p+2]) + w3 v[p+3],  p = n - ca[n] - 1
    v[n] = x[n] + fb tap[n]
    y[n] = (1 - mix) x[n] + mix tap[n]

with v before the block taken from the history.  The contract is
``D_MIN <= ca``: the nearest tap reads v[n - ca[n] + 2], at least
``D_MIN - 2`` = 22 samples back, so a stretch of that many samples reads
only v from before it and is computed at once.  The plain version walks
stretches of exactly ``D_MIN - 2`` (it reads no device value on the host,
so a captured step can hold it); K6 walks stretches of ``min(ca) - 2`` a
tile, up to 32.  The grouping changes no sample's arithmetic.

A call takes x (..., N) float32, ca (..., N) int32 (D_MIN <= ca <= H - 1),
the four cubic weights w (4, ..., N) float32, fb and mix float32 of any
shape that broadcasts to x.shape[:-1] (one value a row: 0-dim for a chain
or a file batch, (S, 1) for a pool's slot-wise params) and hist (..., H)
float32, and returns (y, v), each (..., N).  On the card N is a multiple
of 4 and x, ca and w start on 16-byte boundaries, as
``Flanger.operands`` makes them: the kernel stages its operands 16 bytes
at a time.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.ops.kernels import check, library, stream_ptr, tick

_F32 = torch.float32
_I32 = torch.int32
MAX_HIST = 16352  # csrc/flanger.cu: the ring of v holds at most 16,384 floats
D_MIN = 24  # the least ca: every tap reaches D_MIN - 2 samples back or more


def flanger_file_plain(x, ca, w, fb, mix, hist):
    """The flanger's line recurrence in eager PyTorch, in the kernel's
    order of operations: stretches of ``D_MIN - 2`` samples over every
    row at once, each tap's four products summed left to right, then
    v = x + fb tap; y = (1 - mix) x + mix tap after the last stretch."""
    h, n = hist.shape[-1], x.shape[-1]
    fb, mix = (t.expand(x.shape[:-1])[..., None] for t in (fb, mix))
    span = D_MIN - 2
    line = torch.cat([hist, torch.zeros_like(x)], -1)  # v at h + n
    first = torch.arange(h - 1, h - 1 + n, device=x.device) - ca  # (..., N)
    taps = (first[..., None] + torch.arange(4, device=x.device)).flatten(-2)
    wt = w.movedim(0, -1)  # (..., N, 4)
    tap = torch.empty_like(x)
    for n0 in range(0, n, span):
        n1 = min(n, n0 + span)
        prod = wt[..., n0:n1, :] * line.gather(-1, taps[..., 4 * n0:4 * n1]).unflatten(
            -1, (n1 - n0, 4))
        t = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        tap[..., n0:n1] = t
        line[..., h + n0:h + n1] = x[..., n0:n1] + fb * t
    return (1.0 - mix) * x + mix * tap, line[..., h:]


def _rowwise(shape, rows):
    """Whether a tensor of ``shape`` broadcasts to ``rows``."""
    return len(shape) <= len(rows) and all(a in (1, b) for a, b in zip(shape[::-1], rows[::-1]))


def _check_file(x, ca, w, fb, mix, hist):
    """The operands on either device: x (..., N) float32 with a leading
    axis and N >= 1, ca of x's shape int32, w (4, ...) of x's shape
    float32, hist (..., H) float32 with 1 <= H <= MAX_HIST, fb and mix
    float32 broadcasting to x.shape[:-1], all on x's device; on the card
    contiguous, N a multiple of 4 and x, ca and w 16-byte aligned.  On the
    CPU also D_MIN <= ca <= H - 1, checked without a host read (an
    asynchronous assert, which raises at once there); the card's step
    cannot read ca back, and K6 trusts it.  (Messages are formatted only
    on failure.)"""
    dev = x.device
    card = dev.type == "cuda"
    if not (x.dim() >= 2 and x.dtype == _F32 and x.shape[-1] >= 1
            and (not card or (x.is_contiguous() and x.shape[-1] % 4 == 0
                              and x.data_ptr() % 16 == 0))):
        raise ValueError(f"x: expected a contiguous float32 (..., N) tensor with N >= 1 (on "
                         f"the card N % 4 == 0, 16-byte aligned), got {tuple(x.shape)} "
                         f"{x.dtype}")
    for name, t, dtype, shape in (("ca", ca, _I32, x.shape), ("w", w, _F32, (4,) + x.shape)):
        if not (t.device == dev and t.dtype == dtype and t.shape == shape
                and (not card or (t.is_contiguous() and t.data_ptr() % 16 == 0))):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                             f"{tuple(shape)} on {x.device} (on the card 16-byte aligned), "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    h = hist.shape[-1]
    if not (hist.device == dev and hist.dtype == _F32 and hist.shape[:-1] == x.shape[:-1]
            and 1 <= h <= MAX_HIST and (hist.is_contiguous() or not card)):
        raise ValueError(f"hist: expected a contiguous float32 tensor of shape "
                         f"{tuple(x.shape[:-1])} + (H,), 1 <= H <= {MAX_HIST}, on {x.device}, "
                         f"got {tuple(hist.shape)} {hist.dtype} on {hist.device}")
    for name, t in (("fb", fb), ("mix", mix)):
        if not (t.device == dev and t.dtype == _F32 and _rowwise(t.shape, x.shape[:-1])):
            raise ValueError(f"{name}: expected a float32 tensor on {x.device} broadcasting "
                             f"to {tuple(x.shape[:-1])}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if not card:
        in_reach = ((ca >= D_MIN) & (ca <= h - 1)).all()
        try:
            torch._assert_async(in_reach, "ca out of reach")
        except RuntimeError:
            raise ValueError(f"ca: expected {D_MIN} <= ca <= {h - 1}, got "
                             f"{int(ca.min())}..{int(ca.max())}") from None


def flanger_file(x, ca, w, fb, mix, hist):
    """The flanger's line solve (kernel K6): ``flanger_file_plain``'s
    function in one launch for every row of x (files, slots and channels).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``flanger_file.launches``) or raise."""
    _check_file(x, ca, w, fb, mix, hist)
    if x.device.type != "cuda":
        return flanger_file_plain(x, ca, w, fb, mix, hist)
    n, h = x.shape[-1], hist.shape[-1]
    rows = x.numel() // n
    fb_mix = torch.stack([fb.expand(x.shape[:-1]), mix.expand(x.shape[:-1])])  # one a row
    y, v = torch.empty((2,) + x.shape, dtype=_F32, device=x.device)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_flanger_file(
            x.data_ptr(), ca.data_ptr(), w.data_ptr(), fb_mix[0].data_ptr(),
            fb_mix[1].data_ptr(), hist.data_ptr(), y.data_ptr(), v.data_ptr(), rows, n, h,
            x.get_device(), stream_ptr(x.device))
    check(err, "flanger_file")
    tick(flanger_file)
    return y, v


flanger_file.launches = 0
