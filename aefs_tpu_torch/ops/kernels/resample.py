"""Kernels K1 (the octaver's block step) and K3 (the chorus's block step),
both in csrc/resample.cu, and their plain PyTorch versions.

K1 replaces the TPU kernel ``aefs_tpu/ops/pallas/resample.py:_fused_kernel``
(both octaver grain taps), K3 replaces ``resample.py:_resample_kernel`` (one
stream's tap per row, the chorus's).  On the TPU, XLA fused the phase and
LFO arithmetic around those tap reads; in eager PyTorch it was ~800
(octaver) and ~35 (chorus) launches around a ~1.5 us read.  So each kernel
here is the effect's whole block step in one launch: phase, taps, gains,
blend, the new history and the new phase state.

A step takes the effect's state tree, its smoothed params (0-dim float32
tensors) and x (C, N), and returns (new_state, y) with the state tree's
keys and dtypes.  On the card the outputs are views into one buffer the
wrapper allocates.

Both steps also take the serving pool's leading slot axis: x (S, C, N),
params and scalar state leaves (S,), the history (S, ...).  The kernels
give their grid a slot dimension, so one launch steps every slot, each
slot with its own params and its own serial prologue; a call without slot
dims is the S = 1 launch of the same kernel.  Each slot's outputs equal
the plain step's on that slot bit for bit.  A batched file render passes
its files as the slots with 0-dim params shared by all of them; the
wrappers give such a param one value per slot before either version runs.
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import lead
from aefs_tpu_torch.ops.dsphase import (
    _phase_fold, _phase_ramp, _split12, _stride_levels, _two_sum, ds_exp2_div12)
from aefs_tpu_torch.ops.kernels import check, library, stream_ptr, tick
from aefs_tpu_torch.ops.ringbuf import fractional_read_cubic, ring_push

_F32 = torch.float32
_I32 = torch.int32
_OCT_F32_STATE = ("base_hi", "base_lo", "semi_prev", "step_hi", "step_lo")
_CHORUS_PARAMS = ("rate_hz", "depth_ms", "base_ms", "mix", "spread")


def octaver_taps_plain(hist, x, ago1, ago2):
    """Both octaver grain taps: the gather read of
    ``ringbuf.fractional_read_cubic`` (bulk Hermite + wrap patch) on each
    ``ago`` stream into hist (..., size) ++ x (..., N)."""
    return fractional_read_cubic(hist, x, ago1), fractional_read_cubic(hist, x, ago2)


def fractional_read_plain(hist, x, ago):
    """One stream's tap read per row: ``ringbuf.fractional_read_cubic`` on
    each row of hist (..., R, H), x (..., R, N), ago (..., R, N)."""
    return fractional_read_cubic(hist, x, ago)


def _check_scalar(name, t, dtype, dev, slots):
    """A scalar operand: ``dtype`` on the card, 0-dim without slot dims,
    else one contiguous value per slot."""
    if not (t.get_device() == dev and t.dtype == dtype and t.shape == slots
            and t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(slots)} on cuda:{dev}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def _check_signal(x, hist, rows_of_hist):
    """x (C, N) or (S, C, N) and hist ([S,] [C,] H) on one card, float32,
    unit sample stride; returns x (copied only when its samples are
    strided), its device index and its slot dims (() or (S,)).
    (Messages are formatted only on failure: the checks run every block.)"""
    dev = hist.get_device()
    if dev < 0 or hist.dtype != _F32 or not hist.is_contiguous():
        raise ValueError(f"hist: expected a contiguous float32 CUDA tensor, got "
                         f"{hist.dtype} on {hist.device}")
    if not (x.dim() in (2, 3) and x.get_device() == dev and x.dtype == _F32):
        raise ValueError(f"x: expected (C, N) or (S, C, N) float32 on cuda:{dev}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    slots = x.shape[:-2]
    if (hist.dim() != x.dim() - 1 + rows_of_hist or hist.shape[:-1 - rows_of_hist] != slots
            or (rows_of_hist and hist.shape[-2] != x.shape[-2])):
        raise ValueError(f"hist: shape {tuple(hist.shape)} does not fit x {tuple(x.shape)}")
    if x.shape[-1] < 1 or hist.shape[-1] < 4 or (slots and slots[0] < 1):
        raise ValueError(f"need a block >= 1, a history >= 4 and a slot, got "
                         f"{tuple(x.shape)}, {hist.shape[-1]}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, dev, slots


def _per_slot(p, names, slots):
    """``p`` with every 0-dim param of ``names`` repeated once per slot
    (a batched render's files share their params)."""
    if not slots:
        return p
    return {**p, **{k: p[k].expand(slots).contiguous() for k in names if p[k].dim() == 0}}


def _slot_strides(x, slots):
    """(slot count, x's slot stride) for the kernels' slot grid."""
    return (slots[0], x.stride(0)) if slots else (1, 0)


def octaver_step_plain(state, p, x):
    """The octaver's block step in eager PyTorch (port of the JAX octaver's
    ``process``): the double-single grain phase, both Hermite taps, the
    Hann crossfade and the dry/wet blend.  state: hist (size,), n_abs
    int32, base_hi/base_lo/semi_prev/step_hi/step_lo float32 0-dim; p:
    semitones, mix; x (C, N).  With a leading slot axis: hist (S, size),
    scalars (S,), x (S, C, N)."""
    hist = state["hist"]
    size = hist.shape[-1]
    n = x.shape[-1]
    dev = x.device
    mix = lead(p["mix"], 2)
    mono = torch.mean(x, -2)  # octaver.py:126-128

    # step = (1 - ratio_hi - ratio_lo) / size in double-single: the
    # division remainder is recovered with an exact split product.
    ratio_hi, ratio_lo = ds_exp2_div12(p["semitones"])
    size_f = torch.full((), float(size), device=dev)
    d_hi, d_e = _two_sum(torch.ones((), device=dev), -ratio_hi)
    num_lo = d_e - ratio_lo
    step_hi = d_hi / size_f
    a_hi, a_lo = _split12(step_hi)
    rem = (d_hi - a_hi * size_f) - a_lo * size_f
    step_lo = (rem + num_lo) / size_f

    # Phase as a pure function of the absolute index (bitwise blocksize
    # invariance); a step change re-anchors via an exact fold of the
    # previous step, and the 2^28 re-anchor bounds n_abs far below
    # int32 overflow.
    strides = _stride_levels(step_hi, step_lo)
    refold = (p["semitones"] != state["semi_prev"]) | (state["n_abs"] >= (1 << 28))
    prev = _stride_levels(state["step_hi"], state["step_lo"])
    fb_hi, fb_lo = _phase_fold(state["n_abs"], prev, state["base_hi"], state["base_lo"])
    base_hi = torch.where(refold, fb_hi, state["base_hi"])
    base_lo = torch.where(refold, fb_lo, state["base_lo"])
    n0 = torch.where(refold, torch.zeros_like(state["n_abs"]), state["n_abs"])

    idx = lead(n0) + torch.arange(n, dtype=_I32, device=dev)
    p1 = _phase_ramp(idx, tuple((lead(h), lead(l)) for h, l in strides),
                     lead(base_hi), lead(base_lo))
    p2 = torch.remainder(p1 + 0.5, 1.0)

    s1, s2 = octaver_taps_plain(hist, mono, p1 * size, p2 * size)

    two_pi = 2.0 * math.pi
    g1 = 0.5 * (1.0 - torch.cos(two_pi * p1))  # Hann crossfade (octaver.py:66-67)
    g2 = 0.5 * (1.0 - torch.cos(two_pi * p2))
    wet = s1 * g1 + s2 * g2

    new_state = {
        "hist": ring_push(hist, mono),
        "n_abs": (n0 + n).to(_I32),
        "base_hi": base_hi,
        "base_lo": base_lo,
        "semi_prev": p["semitones"],
        "step_hi": step_hi,
        "step_lo": step_lo,
    }
    # Linear dry/wet blend preserving the dry stereo image
    # (octaver.py:143-150).
    y = x * (1.0 - mix) + wet[..., None, :] * mix
    return new_state, y


def octaver_step(state, p, x):
    """The octaver's block step (kernel K1): ``octaver_step_plain``'s
    function, x (C, N) with C in {1, 2}, or (S, C, N) for S slots, in one
    launch.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``octaver_step.launches``) or raise."""
    hist = state["hist"]
    p = _per_slot(p, ("semitones", "mix"), x.shape[:-2])
    if hist.device.type == "cpu":
        return octaver_step_plain(state, p, x)
    x, dev, slots = _check_signal(x, hist, 0)
    c, n = x.shape[-2:]
    size = hist.shape[-1]
    if c > 2:
        raise ValueError(f"octaver_step takes 1 or 2 channels, got {c}")
    _check_scalar("n_abs", state["n_abs"], _I32, dev, slots)
    for k in _OCT_F32_STATE:
        _check_scalar(k, state[k], _F32, dev, slots)
    _check_scalar("semitones", p["semitones"], _F32, dev, slots)
    _check_scalar("mix", p["mix"], _F32, dev, slots)
    s, lds = _slot_strides(x, slots)
    buf = torch.empty(s * (c * n + size + 6), dtype=_F32, device=x.device)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_octaver_step(
            x.data_ptr(), lds, x.stride(-2), c, n, s, hist.data_ptr(), size,
            p["semitones"].data_ptr(), p["mix"].data_ptr(), state["n_abs"].data_ptr(),
            state["base_hi"].data_ptr(), state["base_lo"].data_ptr(),
            state["semi_prev"].data_ptr(), state["step_hi"].data_ptr(),
            state["step_lo"].data_ptr(), buf.data_ptr(), dev, stream_ptr(x.device))
    check(err, "octaver_step")
    tick(octaver_step)
    y, new_hist, tail = buf.split_with_sizes((s * c * n, s * size, 6 * s))
    # Rows of (6, S), or six 0-dim scalars without slot dims; no further
    # views, as each costs host time on every block.
    n_abs, base_hi, base_lo, semi_prev, step_hi, step_lo = (
        tail.view(6, s) if slots else tail).unbind()
    return {"hist": new_hist.view(s, size) if slots else new_hist,
            "n_abs": n_abs.view(_I32), "base_hi": base_hi, "base_lo": base_lo,
            "semi_prev": semi_prev, "step_hi": step_hi, "step_lo": step_lo}, y.view(*slots, c, n)


octaver_step.launches = 0


def chorus_step_plain(state, p, x, fs):
    """The chorus's block step in eager PyTorch (port of the JAX chorus's
    ``process``): the LFO ramp and channel spread, the delay law, the
    clamped Hermite tap per channel, the blend, the history push and the
    phase advance.  state: hist (C, H), ph_hi/ph_lo 0-dim; p: rate_hz,
    depth_ms, base_ms, mix, spread; x (C, N); fs the sample rate.  With a
    leading slot axis: hist (S, C, H), scalars (S,), x (S, C, N)."""
    # Imported here: importing models/ loads the chorus, which imports this module.
    from aefs_tpu_torch.models.lfo import (
        TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp, spread_channels)

    c, n = x.shape[-2:]
    hist_len = state["hist"].shape[-1]
    fs_t = fs_tensor(fs, x.device)
    dph = p["rate_hz"] / fs_t
    ph_c = spread_channels(lfo_ramp(state["ph_hi"], state["ph_lo"], dph, n),
                           p["spread"], c)
    delay_ms = lead(p["base_ms"], 2) + lead(p["depth_ms"], 2) * f64(torch.sin, TWO_PI * ph_c)
    ms_per_s = torch.full((), 1000.0, device=x.device)
    ago = torch.clamp(delay_ms * (fs_t / ms_per_s), 2.0, float(hist_len - 2))

    tap = fractional_read_plain(state["hist"], x, ago)
    mix = lead(p["mix"], 2)
    y = (1.0 - mix) * x + mix * tap

    new_hist = torch.cat([state["hist"], x], -1)[..., -hist_len:]
    hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
    return {"hist": new_hist, "ph_hi": hi, "ph_lo": lo}, y


def chorus_step(state, p, x, fs):
    """The chorus's block step (kernel K3): ``chorus_step_plain``'s
    function in one launch for all channels and, with x (S, C, N), all
    slots.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``chorus_step.launches``) or raise."""
    hist = state["hist"]
    p = _per_slot(p, _CHORUS_PARAMS, x.shape[:-2])
    if hist.device.type == "cpu":
        return chorus_step_plain(state, p, x, fs)
    x, dev, slots = _check_signal(x, hist, 1)
    c, n = x.shape[-2:]
    hl = hist.shape[-1]
    _check_scalar("ph_hi", state["ph_hi"], _F32, dev, slots)
    _check_scalar("ph_lo", state["ph_lo"], _F32, dev, slots)
    for k in _CHORUS_PARAMS:
        _check_scalar(k, p[k], _F32, dev, slots)
    s, lds = _slot_strides(x, slots)
    buf = torch.empty(s * (c * (n + hl) + 2), dtype=_F32, device=x.device)
    with torch.cuda.device(x.device):  # the operands' card, current for PyTorch too
        err = library().aefs_chorus_step(
            x.data_ptr(), lds, x.stride(-2), c, n, s, hist.data_ptr(), hl, float(fs),
            p["rate_hz"].data_ptr(), p["depth_ms"].data_ptr(), p["base_ms"].data_ptr(),
            p["mix"].data_ptr(), p["spread"].data_ptr(), state["ph_hi"].data_ptr(),
            state["ph_lo"].data_ptr(), buf.data_ptr(), dev, stream_ptr(x.device))
    check(err, "chorus_step")
    tick(chorus_step)
    y, new_hist, tail = buf.split_with_sizes((s * c * n, s * c * hl, 2 * s))
    ph_hi, ph_lo = (tail.view(2, s) if slots else tail).unbind()
    return ({"hist": new_hist.view(*slots, c, hl), "ph_hi": ph_hi, "ph_lo": ph_lo},
            y.view(*slots, c, n))


chorus_step.launches = 0
