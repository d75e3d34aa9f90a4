"""Kernel K5 (the biquad's streaming block step), in csrc/biquad.cu, and
its plain PyTorch version.

K5 replaces no TPU kernel: the JAX package's biquad is XLA ops
(``aefs_tpu/ops/scan.py``'s ``biquad_block``, no ``pallas_call``), which
XLA fuses into the step.  In eager PyTorch the block step is ~490 kernels
(the seven filter types' RBJ rows and ``linrec2``'s Hillis levels over six
float64 planes), each a node of the captured step graph.  The kernel is
the whole step in one launch: the coefficients, the float64 solve and the
new state, for every slot and channel, bit-equal to the plain version.

A step takes the effect's state ``{"df1": (C, 4)}``, its smoothed params
(0-dim float32 tensors) and a block x (C, N) of 1 to 1,023 samples, and
returns (new_state, y).  With the serving pool's leading slot axis: x
(S, C, N), df1 (S, C, 4), params (S,) or 0-dim (shared by every slot: a
batched render's files).  Longer signals take the file solve
(``ops/scan.py:biquad_block``'s chunked Toeplitz form) and never come
here.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.ops.kernels import check, library, stream_ptr, tick
from aefs_tpu_torch.ops.kernels.resample import _per_slot, _slot_strides
from aefs_tpu_torch.ops.scan import BIQUAD_FILE_SOLVE

_F32 = torch.float32
_PARAMS = ("filter_type", "cutoff_hz", "q", "gain_db")


def biquad_step_plain(state, p, x, fs):
    """The biquad's block step in eager PyTorch: the effect's RBJ
    coefficients (``models/biquad.py:coefficients``), then the float64
    block solve (``ops/scan.py:biquad_block``), both as ``models/biquad.py``
    binds them for its file path too.  state: df1 ([S,] C, 4); p:
    filter_type, cutoff_hz, q, gain_db, 0-dim or (S,); x ([S,] C, N)."""
    # Imported here: importing models/ loads the biquad, which imports this module.
    from aefs_tpu_torch.models import biquad

    y, df1 = biquad.biquad_block(x, *biquad.coefficients(p, fs), state["df1"])
    return {"df1": df1}, y


def _check_block(df1, p, x):
    """The operands on either device: x (C, N) or (S, C, N) float32 with
    1 <= N < BIQUAD_FILE_SOLVE; df1 ([S,] C, 4) float32; every param
    float32, 0-dim or (S,); all on x's device.  On the card also the
    contiguity the kernel reads them with.  Returns x with a unit sample
    stride.  (Messages are formatted only on failure: the checks run every
    block.)"""
    dev = x.get_device()
    if not (x.dim() in (2, 3) and x.dtype == _F32 and 1 <= x.shape[-1] < BIQUAD_FILE_SOLVE):
        raise ValueError(f"x: expected (C, N) or (S, C, N) float32 with 1 <= N < "
                         f"{BIQUAD_FILE_SOLVE}, got {tuple(x.shape)} {x.dtype}")
    slots = x.shape[:-2]
    card = dev >= 0
    if not (df1.get_device() == dev and df1.dtype == _F32
            and df1.shape == x.shape[:-1] + (4,) and (df1.is_contiguous() or not card)):
        raise ValueError(f"df1: expected a contiguous float32 tensor of shape "
                         f"{tuple(x.shape[:-1]) + (4,)} on {x.device}, got "
                         f"{tuple(df1.shape)} {df1.dtype} on {df1.device}")
    for k in _PARAMS:
        t = p[k]
        if not (t.get_device() == dev and t.dtype == _F32 and t.shape in ((), slots)
                and (t.is_contiguous() or not card)):
            raise ValueError(f"{k}: expected a contiguous float32 tensor of shape () or "
                             f"{tuple(slots)} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x


def biquad_step(state, p, x, fs):
    """The biquad's block step (kernel K5): ``biquad_step_plain``'s
    function in one launch for all channels and, with x (S, C, N), all
    slots.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``biquad_step.launches``) or raise."""
    df1 = state["df1"]
    x = _check_block(df1, p, x)
    if x.device.type == "cpu":
        return biquad_step_plain(state, p, x, fs)
    slots = x.shape[:-2]
    p = _per_slot(p, _PARAMS, slots)
    c, n = x.shape[-2:]
    s, lds = _slot_strides(x, slots)
    buf = torch.empty(s * c * (n + 4), dtype=_F32, device=x.device)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_biquad_step(
            x.data_ptr(), lds, x.stride(-2), c, n, s, df1.data_ptr(), int(fs),
            p["filter_type"].data_ptr(), p["cutoff_hz"].data_ptr(), p["q"].data_ptr(),
            p["gain_db"].data_ptr(), buf.data_ptr(), x.get_device(), stream_ptr(x.device))
    check(err, "biquad_step")
    tick(biquad_step)
    y, new_df1 = buf.split_with_sizes((s * c * n, s * c * 4))
    return {"df1": new_df1.view(df1.shape)}, y.view(x.shape)


biquad_step.launches = 0
