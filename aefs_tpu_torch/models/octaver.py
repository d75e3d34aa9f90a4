"""Granular delay-line pitch shifter (port of aefs_tpu/models/octaver.py).

Two read taps driven by phasors offset 0.5 apart, Hann crossfade gains,
4-point Hermite interpolation (reference octaver.py:17-82).  The phasor is
affine per sample and a pure function of the absolute sample index, in
double-single arithmetic (ops/dsphase.py).  Every generic block (streaming,
and file renders at non-octave ratios) is one call of the block step K1
(``ops/kernels/resample.py:octaver_step``): phase, both taps, gains, blend
and the new state in one launch on the card, its plain eager version on the
CPU.  Whole-octave file renders take the exact closed-form grid taps
(ops/gridtaps.py), and so does the exact-grid streaming specialization
(``grid_semitones``, which the pool's grid mode bakes): an integer phase
numerator and the taps on the rational grid every block, with only ``mix``
live.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aefs_tpu_torch.core.params import ParamSpec, lead
from aefs_tpu_torch.models.base import EffectModel
from aefs_tpu_torch.ops.kernels.resample import octaver_step
from aefs_tpu_torch.ops.ringbuf import ring_push

_F32 = torch.float32
_I32 = torch.int32

# semi_prev init: outside the legal [-24, 24] range, so the first block
# always re-anchors (an exact no-op at n_abs = 0).
_SEMI_SENTINEL = 1.0e9


class Octaver(EffectModel):
    kind = "octaver"

    PARAMS = {
        "semitones": ParamSpec(-12.0, -24.0, 24.0, smooth="step", step=0.5),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="step", step=0.05),
    }

    def __init__(self, fs, blocksize, channels=2, window_ms=40.0,
                 file_semitones=None, resample_tile=None,
                 grid_semitones=None, grid_phase_lock=False, **config):
        super().__init__(fs, blocksize, channels, **config)
        # Grain window; minimum size guards tiny rates (octaver.py:106).
        self.size = max(int(fs * float(window_ms) / 1000.0), 16)
        # ``resample_tile`` sizes the reference's TPU tiles; it is accepted
        # for config compatibility and ignored: K1 reads any block and ring
        # size, so every generic block takes it.
        # Whole-octave file mode: exact closed-form grid taps.
        from aefs_tpu_torch.ops.gridtaps import (
            pow2_exponent, pow2_geometry_ok, pow2_stream_geometry_ok)

        e = pow2_exponent(file_semitones)
        self._pow2_e = e if e is not None and pow2_geometry_ok(self.size, e) else None
        # Whole-octave streaming specialization (opt-in static): the phase is
        # an exact integer numerator and the taps are evaluated on the
        # rational grid every block (gridtaps.octaver_taps_pow2_stream).  The
        # ``semitones`` target is baked; only ``mix`` stays live.
        ge = pow2_exponent(grid_semitones)
        self._grid_e = (ge if ge is not None
                        and pow2_stream_geometry_ok(self.size, ge, blocksize) else None)
        # Phase-locked grid (the pool's grid mode): the integer phase arrives
        # in a "grid_phase" pseudo-param its caller advances each block
        # (server/pool.py, host-side), shared by every slot, instead of
        # per-stream state.  Absolute grain phase is inaudible, so a session
        # joining a running pool at the shared phase matches the reference
        # from its own first block.
        self._phase_lock = bool(grid_phase_lock) and self._grid_e is not None
        if self._phase_lock:
            self.PARAMS = {**self.PARAMS, "grid_phase": ParamSpec(0.0, 0.0, float(2 ** 24))}

    def grid_phase_advance(self, n=None):
        """(per-block advance, modulus) of the integer phase numerator: the
        recurrence a phase-locking caller applies per block."""
        e = self._grid_e
        n = self.blocksize if n is None else int(n)
        if e < 0:
            d = 1 << (-e)
            return (n * (d - 1)) % (d * self.size), d * self.size
        r = 1 << e
        return (-n * (r - 1)) % self.size, self.size

    def init_state(self):
        dev = self.device
        if self._grid_e is not None:
            hist = torch.zeros((self.size,), device=dev)
            if self._phase_lock:  # the phase arrives as the grid_phase param
                return {"hist": hist}
            return {"hist": hist, "num": torch.zeros((), dtype=_I32, device=dev)}
        # The phase is a pure function of the absolute sample index since
        # the last step change: n_abs counts samples since the anchor,
        # (base_hi, base_lo) is the DS phase at the anchor, semi_prev and
        # step_* identify the anchored step.
        zero = torch.zeros((), device=dev)
        return {
            "hist": torch.zeros((self.size,), device=dev),
            "n_abs": torch.zeros((), dtype=_I32, device=dev),
            "base_hi": zero.clone(),
            "base_lo": zero.clone(),
            "semi_prev": torch.full((), _SEMI_SENTINEL, device=dev),
            "step_hi": zero.clone(),
            "step_lo": zero.clone(),
        }

    def _process_grid(self, state, p, x):
        """Exact-grid streaming step (``grid_semitones`` baked, only ``mix``
        live): the phase is an integer numerator, so nothing accumulates in
        float32 on the tap path."""
        from aefs_tpu_torch.ops.gridtaps import octaver_taps_pow2_stream

        mix = lead(p["mix"], 2)
        mono = torch.mean(x, -2)  # octaver.py:126-128
        num0 = p["grid_phase"] if self._phase_lock else state["num"]
        s1, s2, p1, p2, num = octaver_taps_pow2_stream(state["hist"], mono, self._grid_e, num0)
        two_pi = 2.0 * math.pi
        g1 = 0.5 * (1.0 - torch.cos(two_pi * p1))  # octaver.py:66-67
        g2 = 0.5 * (1.0 - torch.cos(two_pi * p2))
        wet = s1 * g1 + s2 * g2
        new_state = {"hist": ring_push(state["hist"], mono)}
        if not self._phase_lock:
            new_state["num"] = num
        y = x * (1.0 - mix) + wet[..., None, :] * mix
        return new_state, y

    def process(self, state, p, x):
        if self._grid_e is not None:
            return self._process_grid(state, p, x)
        return octaver_step(state, p, x)

    def process_file(self, state, p, x):
        """Whole-file path.  At whole-octave baked ratios the taps are the
        exact closed form on the rational position grid (fresh phase,
        params at their baked targets); otherwise the generic ``process``
        (K1 over the whole file, its slot grid over a batch's files).
        x: (C, N), or (F, C, N) for F files with (F, ...) state."""
        if self._pow2_e is None:
            return self.process(state, p, x)
        from aefs_tpu_torch.ops.gridtaps import octaver_taps_pow2

        e = self._pow2_e
        size = self.size
        n = x.shape[-1]
        files = x.shape[:-2]
        dev = x.device
        mix = p["mix"]
        mono = torch.mean(x, -2)
        hist = state["hist"]

        s1, s2, _, _ = octaver_taps_pow2(hist, mono, e)
        # The Hann gains are exactly periodic on the pow-2 grid: one period
        # of cos tiled over the signal is bitwise the full-length one.
        if e < 0:
            d = 1 << (-e)
            per = d * size
            r1p = torch.remainder(torch.arange(per, dtype=_I32, device=dev) * (d - 1), per)
        else:
            per = size
            r1p = torch.remainder(
                -torch.arange(per, dtype=_I32, device=dev) * ((1 << e) - 1), per)
        r2p = torch.remainder(r1p + per // 2, per)
        pf = torch.full((), float(per), device=dev)
        two_pi = 2.0 * math.pi
        g1p = 0.5 * (1.0 - torch.cos(two_pi * (r1p.to(_F32) / pf)))
        g2p = 0.5 * (1.0 - torch.cos(two_pi * (r2p.to(_F32) / pf)))
        k_tiles = -(-n // per)
        g1 = g1p.repeat(k_tiles)[:n]  # octaver.py:66-67
        g2 = g2p.repeat(k_tiles)[:n]
        wet = s1 * g1 + s2 * g2

        # Exact phase advance p(n) = mod(n * (1 - 2^e) / size, 1), carried
        # into the generic state as a host-computed DS base; the sentinel
        # forces a (no-op) re-anchor if a generic block continues.
        if e < 0:
            d = 1 << (-e)
            ph = (n * (d - 1)) % (d * size) / (d * size)
        else:
            ph = (-n * ((1 << e) - 1)) % size / size
        ph_hi = np.float32(ph)

        def scalar(v, dtype=_F32):
            return torch.full(files, v, dtype=dtype, device=dev)

        new_state = {
            "hist": ring_push(hist, mono),
            "n_abs": scalar(0, _I32),
            "base_hi": scalar(float(ph_hi)),
            "base_lo": scalar(float(np.float32(ph - float(ph_hi)))),
            "semi_prev": scalar(_SEMI_SENTINEL),
            "step_hi": scalar(0.0),
            "step_lo": scalar(0.0),
        }
        y = x * (1.0 - mix) + wet[..., None, :] * mix
        return new_state, y
